/* vgpu-validator: the port's entitlement checker, a copy of the JAX
 * package's lib/vtpu/validator.c under the GPU product's names
 * (reference slot: the prebuilt lib/nvidia/vgpuvalidator binary, mounted
 * into containers when the host carries a license,
 * plugin/server.go:384-396; the reference ships no source).
 *
 *   license file (key=value lines, order-independent except sig last):
 *     product=vgpu
 *     expires=<unix seconds>
 *     nodes=<glob, fnmatch(3) against the hostname; "*" = any>
 *     max_chips=<int, informational>
 *     sig=<hex HMAC-SHA256 over every line above, keyed by the secret>
 *
 *   secret: VGPU_LICENSE_SECRET env, or the file named by
 *   VGPU_LICENSE_SECRET_FILE (default /etc/vgpu/license.secret, never a
 *   path inside the mounted license dir); VGPU_LICENSE_NODE overrides the
 *   hostname matched against nodes= (vtpu_torch/api names all three).
 *
 * TRUST MODEL: HMAC is symmetric: whoever can verify can also sign. The
 * check is an operator's entitlement gate, bypassable by the tenant in its
 * own process space, as the reference's vgpuvalidator is. The plugin
 * mounts only the license FILE, never the directory that may hold the
 * secret.
 *
 * Exit 0 = valid; 1 = invalid/expired/tampered/unsigned; 2 = usage/IO
 * error. A container's entrypoint (or an init container) runs
 *   vgpu-validator /vgpu/license
 * the way the reference's postStart runs vgpuvalidator; with a second
 * argument --sign it prints the sig= line for the text before it.
 *
 * SHA-256 from FIPS 180-4; HMAC from RFC 2104.
 */
#define _GNU_SOURCE
#include <fnmatch.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

/* ------------------------------------------------------ SHA-256 ---- */
typedef struct {
  uint32_t h[8];
  uint64_t len;
  uint8_t buf[64];
  size_t fill;
} sha256_t;

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_init(sha256_t *s) {
  static const uint32_t h0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(s->h, h0, sizeof(h0));
  s->len = 0;
  s->fill = 0;
}

static void sha256_block(sha256_t *s, const uint8_t *p) {
  uint32_t w[64], a, b, c, d, e, f, g, h;
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
           (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  a = s->h[0]; b = s->h[1]; c = s->h[2]; d = s->h[3];
  e = s->h[4]; f = s->h[5]; g = s->h[6]; h = s->h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s->h[0] += a; s->h[1] += b; s->h[2] += c; s->h[3] += d;
  s->h[4] += e; s->h[5] += f; s->h[6] += g; s->h[7] += h;
}

static void sha256_update(sha256_t *s, const void *data, size_t n) {
  const uint8_t *p = data;
  s->len += n;
  while (n) {
    size_t take = 64 - s->fill;
    if (take > n) take = n;
    memcpy(s->buf + s->fill, p, take);
    s->fill += take;
    p += take;
    n -= take;
    if (s->fill == 64) {
      sha256_block(s, s->buf);
      s->fill = 0;
    }
  }
}

static void sha256_final(sha256_t *s, uint8_t out[32]) {
  uint64_t bits = s->len * 8;
  uint8_t pad = 0x80;
  sha256_update(s, &pad, 1);
  pad = 0;
  while (s->fill != 56) sha256_update(s, &pad, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
  sha256_update(s, lenb, 8);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(s->h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(s->h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(s->h[i] >> 8);
    out[4 * i + 3] = (uint8_t)s->h[i];
  }
}

/* ------------------------------------------------- HMAC-SHA256 ----- */
static void hmac_sha256(const uint8_t *key, size_t klen, const uint8_t *msg,
                        size_t mlen, uint8_t out[32]) {
  uint8_t k[64] = {0}, pad[64], inner[32];
  sha256_t s;
  if (klen > 64) {
    sha256_init(&s);
    sha256_update(&s, key, klen);
    sha256_final(&s, k); /* first 32 bytes; rest stay zero */
  } else {
    memcpy(k, key, klen);
  }
  for (int i = 0; i < 64; i++) pad[i] = k[i] ^ 0x36;
  sha256_init(&s);
  sha256_update(&s, pad, 64);
  sha256_update(&s, msg, mlen);
  sha256_final(&s, inner);
  for (int i = 0; i < 64; i++) pad[i] = k[i] ^ 0x5c;
  sha256_init(&s);
  sha256_update(&s, pad, 64);
  sha256_update(&s, inner, 32);
  sha256_final(&s, out);
}

/* --------------------------------------------------- validation ---- */
static int hexval(int c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

static int load_secret(uint8_t *buf, size_t cap, size_t *out_len) {
  const char *env = getenv("VGPU_LICENSE_SECRET");
  if (env && *env) {
    size_t n = strlen(env);
    if (n >= cap) { /* refuse, never silently truncate: a truncated key
                     * disagrees with every standard HMAC signer */
      fprintf(stderr, "vgpu-validator: secret too long (>%zu)\n", cap - 1);
      return -1;
    }
    memcpy(buf, env, n);
    *out_len = n;
    return 0;
  }
  const char *path = getenv("VGPU_LICENSE_SECRET_FILE");
  if (!path || !*path) path = "/etc/vgpu/license.secret";
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  size_t n = fread(buf, 1, cap, f);
  fclose(f);
  if (n >= cap) {
    fprintf(stderr, "vgpu-validator: secret file too long (>%zu)\n",
            cap - 1);
    return -1;
  }
  while (n && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) n--;
  if (!n) return -1;
  *out_len = n;
  return 0;
}

int main(int argc, char **argv) {
  const char *path = argc > 1 ? argv[1] : "/vgpu/license";
  int gen_mode = argc > 2 && strcmp(argv[2], "--sign") == 0;
  FILE *f = fopen(path, "rb");
  if (!f) {
    fprintf(stderr, "vgpu-validator: cannot open %s\n", path);
    return 2;
  }
  char body[8192];
  size_t blen = fread(body, 1, sizeof(body) - 1, f);
  if (blen == sizeof(body) - 1 && fgetc(f) != EOF) {
    /* a silently truncated read would fail later as "signature
     * mismatch" — misleading; an over-sized license is a usage error */
    fprintf(stderr, "vgpu-validator: license file too large (>%zu bytes)\n",
            sizeof(body) - 1);
    fclose(f);
    return 2;
  }
  fclose(f);
  body[blen] = 0;

  /* split off the sig= line; everything before it is the signed text */
  char *sig_line = strstr(body, "sig=");
  while (sig_line && sig_line != body && sig_line[-1] != '\n')
    sig_line = strstr(sig_line + 1, "sig=");
  size_t signed_len = sig_line ? (size_t)(sig_line - body) : blen;

  uint8_t secret[4096];
  size_t slen = 0;
  if (load_secret(secret, sizeof(secret), &slen) != 0) {
    fprintf(stderr, "vgpu-validator: no signing secret "
                    "(VGPU_LICENSE_SECRET[_FILE])\n");
    return 2;
  }
  uint8_t mac[32];
  hmac_sha256(secret, slen, (const uint8_t *)body, signed_len, mac);

  if (gen_mode) { /* operator convenience: emit the sig line */
    printf("sig=");
    for (int i = 0; i < 32; i++) printf("%02x", mac[i]);
    printf("\n");
    return 0;
  }

  if (!sig_line) {
    fprintf(stderr, "vgpu-validator: license has no sig= line\n");
    return 1;
  }
  const char *hex = sig_line + 4;
  if (strlen(hex) < 64) {
    /* guard BEFORE the digit loop: hexval(hex[2*i+1]) on a truncated
     * sig= line would read one byte past the NUL terminator */
    fprintf(stderr, "vgpu-validator: malformed sig (truncated)\n");
    return 1;
  }
  uint8_t diff = 0; /* constant-time-ish compare */
  for (int i = 0; i < 32; i++) {
    int hi = hexval(hex[2 * i]), lo = hexval(hex[2 * i + 1]);
    if (hi < 0 || lo < 0) {
      fprintf(stderr, "vgpu-validator: malformed sig\n");
      return 1;
    }
    diff |= (uint8_t)((hi << 4 | lo) ^ mac[i]);
  }
  if (diff) {
    fprintf(stderr, "vgpu-validator: signature mismatch (tampered "
                    "or wrong secret)\n");
    return 1;
  }

  /* signed fields */
  long expires = 0;
  char nodes[256] = "*";
  char *line = body;
  while (line && line < body + signed_len) {
    char *nl = memchr(line, '\n', signed_len - (size_t)(line - body));
    size_t ll = nl ? (size_t)(nl - line) : signed_len - (size_t)(line - body);
    if (ll > 8 && !strncmp(line, "expires=", 8))
      expires = strtol(line + 8, NULL, 10);
    else if (ll > 6 && !strncmp(line, "nodes=", 6)) {
      size_t n = ll - 6;
      if (n >= sizeof(nodes)) n = sizeof(nodes) - 1;
      memcpy(nodes, line + 6, n);
      nodes[n] = 0;
    }
    line = nl ? nl + 1 : NULL;
  }
  if (expires <= 0 || time(NULL) > expires) {
    fprintf(stderr, "vgpu-validator: license expired (expires=%ld)\n",
            expires);
    return 1;
  }
  char host[256] = "";
  gethostname(host, sizeof(host) - 1);
  const char *want = getenv("VGPU_LICENSE_NODE");
  if (want && *want) snprintf(host, sizeof(host), "%s", want);
  if (fnmatch(nodes, host, 0) != 0) {
    fprintf(stderr, "vgpu-validator: host %s not covered by nodes=%s\n",
            host, nodes);
    return 1;
  }
  printf("vgpu-validator: license valid (nodes=%s, expires=%ld)\n", nodes,
         expires);
  return 0;
}
