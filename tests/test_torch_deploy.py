"""The port's deployment, on the CPU: the chart deploy/helm/vgpu, the image
recipe docker/Dockerfile.vgpu and the examples examples/gpu/.

There is no helm here: vtpu_torch.deploy renders the chart's subset of Go
templates and reads its subset of YAML, and fails on anything outside
them. The tests hold that loader to PyYAML on every rendered document,
then check the chart against the port it deploys: its objects are the
JAX chart's, kind for kind and name for name; each daemon's command
parses with that daemon's own argument parser; every env name it sets is
a knob of vtpu_torch/contracts.py; the plugin's host mounts are the paths
the port's Allocate names; the RBAC grants every verb of the port's
KubeClient, leases included; each example pod goes through the port's
/webhook and /filter on two 8-card H100 nodes and is placed, or refused
for the reason its header states. The image copies only what exists and
installs no torch, and the three daemons' entry points load no torch,
jax or vtpu module.
"""

from __future__ import annotations

import asyncio
import base64
import glob
import json
import os
import re
import subprocess
import sys
import time

import grpc
import pytest
import yaml
from aiohttp.test_utils import TestClient, TestServer

from vtpu_torch import api, contracts, deploy, device
from vtpu_torch.plugin import deviceplugin_pb2 as pb
from vtpu_torch.plugin import dp_grpc, server
from vtpu_torch.plugin.config import PluginConfig
from vtpu_torch.plugin.nvml import ChipInfo, FakeNvmlLib
from vtpu_torch.plugin.register import Registrar
from vtpu_torch.scheduler import Scheduler
from vtpu_torch.scheduler.loadtest import apply_patch
from vtpu_torch.scheduler.routes import build_app
from vtpu_torch.util import client as clientmod
from vtpu_torch.util import codec, nodelock
from vtpu_torch.util.client import FakeKubeClient
from vtpu_torch.util.types import DeviceInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CHART = os.path.join(REPO, "deploy", "helm", "vtpu")
H100 = "NVIDIA-NVIDIA H100 80GB HBM3"
HGX_NUMA = (0, 0, 0, 0, 1, 1, 1, 1)

#: value sets the chart is rendered at: the defaults, and each switch
#: its templates test turned the other way
VALUES = {
    "defaults": {},
    "ha-off": {"scheduler": {"ha": {"enabled": False}}},
    "one-lease": {"scheduler": {"ha": {"shardGroups": 1}}},
    "exposed-and-elastic": {
        "monitor": {"infoBind": "0.0.0.0", "profileExport": False},
        "scheduler": {"rebalanceSeconds": 30, "migrateSeconds": 10},
        "devicePlugin": {"disableCoreLimit": True, "hostMemCapacityMB": 0,
                         "nodeConfig": [{"name": "n1",
                                         "devicesplitcount": 4}]}},
    "cert-manager": {"webhook": {"certManager": {"enabled": True}}},
}


def objects(values=None):
    return deploy.objects(values or {})


# ---------------------------------------------------------------------------
# rendering and the YAML subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VALUES))
def test_chart_renders_and_reads_as_pyyaml_does(name):
    rendered = deploy.render(VALUES[name])
    assert sorted(rendered) == sorted(
        f for f in deploy.chart_files() if not f.endswith(".tpl"))
    for tname, text in rendered.items():
        assert deploy.load_yaml(text) == list(yaml.safe_load_all(text)), \
            tname
    for obj in objects(VALUES[name]):
        assert obj["apiVersion"] and obj["kind"]
        assert obj["metadata"]["name"].startswith(f"{deploy.RELEASE}-vgpu")


@pytest.mark.parametrize("path", ["Chart.yaml", "values.yaml"]
                         + sorted(glob.glob(os.path.join(
                             REPO, "examples", "gpu", "*.yaml"))))
def test_chart_files_and_examples_read_as_pyyaml_does(path):
    text = open(os.path.join(deploy.CHART_DIR, path)).read()
    assert deploy.load_yaml(text) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("template,why", [
    ('{{ range .Values.x }}{{ end }}', "range"),
    ('{{ with .Values.image }}x{{ end }}', "with"),
    ('{{ .Values.image.repository | upper }}', "upper"),
    ('{{ .Values.nosuch }}', "no value"),
    ('{{/* a comment */}}', "comment"),
    ('{{ if .Values.image }}x', "unclosed"),
    ('{{ include "nosuch" . }}', "undefined template"),
    ('{{ .Values.image }}', "collection"),
])
def test_renderer_refuses_what_it_does_not_know(tmp_path, template, why):
    chart = tmp_path / "chart"
    (chart / "templates").mkdir(parents=True)
    (chart / "Chart.yaml").write_text(
        "name: c\nversion: 0.1.0\nappVersion: \"0.1.0\"\n")
    (chart / "values.yaml").write_text("image:\n  repository: r\nx: []\n")
    (chart / "templates" / "t.yaml").write_text(template)
    with pytest.raises(deploy.ChartError):
        deploy.render(chart_dir=str(chart))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n", "a: {b: 1}\n", "a:\n\t- 1\n",
    "a: [[1]]\n", "%YAML 1.2\n---\na: 1\n", "a: 1\na: 2\n",
])
def test_yaml_subset_refuses_what_it_does_not_know(text):
    with pytest.raises(deploy.ChartError):
        deploy.load_yaml(text)


# ---------------------------------------------------------------------------
# the JAX chart's objects, kind for kind
# ---------------------------------------------------------------------------

def jax_chart_objects():
    """(kind, name suffix) of every object the JAX chart's templates
    declare, read from their text (its templates use constructs the
    port's renderer rightly refuses)."""
    out = set()
    for path in glob.glob(os.path.join(JAX_CHART, "templates", "**",
                                       "*.yaml"), recursive=True):
        for doc in re.split(r"^---$", open(path).read(), flags=re.M):
            kind = re.search(r"^kind: (.+)$", doc, re.M)
            name = re.search(r'^  name: \{\{ include "vtpu\.fullname" '
                             r'\. \}\}(\S*)$', doc, re.M)
            if not (kind and name):
                continue
            kinds = kind.group(1).strip()
            if "ternary" in kinds:
                kinds = re.findall(r'"(\w+)"', kinds)
            else:
                kinds = [kinds]
            out.update((k, name.group(1)) for k in kinds)
    return out


def test_objects_are_the_jax_charts():
    port = set()
    for values in VALUES.values():
        prefix = f"{deploy.RELEASE}-vgpu"
        port.update((o["kind"], o["metadata"]["name"][len(prefix):])
                    for o in objects(values))
    jax = jax_chart_objects()
    assert len(jax) >= 20
    assert port == jax


# ---------------------------------------------------------------------------
# the daemons' commands, env and mounts
# ---------------------------------------------------------------------------

def _parse(container, argv):
    if container == "device-plugin":
        from vtpu_torch.plugin.__main__ import parse_args
    elif container == "monitor":
        from vtpu_torch.monitor.__main__ import parse_args
    else:
        from vtpu_torch.scheduler.__main__ import parse_args
    return parse_args(argv)


@pytest.mark.parametrize("values", sorted(VALUES))
@pytest.mark.parametrize("container", sorted(deploy.DAEMONS))
def test_daemon_command_parses_with_its_entry_point(container, values):
    objs = objects(VALUES[values])
    args = _parse(container, deploy.daemon_argv(objs, container))
    vals = deploy.load_yaml(open(os.path.join(
        deploy.CHART_DIR, "values.yaml")).read())[0]
    if container == "device-plugin":
        assert args.shim_host_dir == vals["devicePlugin"]["shimHostDir"]
        assert args.socket_dir == vals["devicePlugin"]["socketDir"]
        assert args.device_split_count == \
            vals["devicePlugin"]["deviceSplitCount"]
        assert args.health_port == vals["devicePlugin"]["healthPort"]
    elif container == "monitor":
        assert args.containers_dir == os.path.join(
            vals["devicePlugin"]["shimHostDir"], "containers")
        assert args.sweep_interval == vals["monitor"]["sweepInterval"]
        assert args.info_port == vals["monitor"]["infoPort"]
    else:
        assert args.http_bind.endswith(f":{vals['scheduler']['webhookPort']}")
        assert args.scheduler_name == api.SCHEDULER_NAME
        assert args.ha is (values != "ha-off")


def test_replaced_paths_and_ports_reach_the_argv():
    """What chip_smoke.py replaces, and only through the chart's values."""
    objs = objects({"devicePlugin": {"shimHostDir": "/x/vgpu",
                                     "socketDir": "/x/dp",
                                     "healthPort": 1234},
                    "monitor": {"metricsPort": 2345, "infoPort": 3456},
                    "scheduler": {"webhookPort": 4567, "metricsPort": 5678,
                                  "tlsDir": "/x/tls"}})
    plugin = _parse("device-plugin", deploy.daemon_argv(objs,
                                                         "device-plugin"))
    assert (plugin.shim_host_dir, plugin.socket_dir, plugin.health_port) \
        == ("/x/vgpu", "/x/dp", 1234)
    mon = _parse("monitor", deploy.daemon_argv(objs, "monitor"))
    assert (mon.containers_dir, mon.metrics_port, mon.info_port) == \
        ("/x/vgpu/containers", 2345, 3456)
    sched = _parse("vgpu-scheduler-extender", deploy.daemon_argv(
        objs, "vgpu-scheduler-extender"))
    assert (sched.http_bind, sched.metrics_bind, sched.cert_file,
            sched.key_file) == ("0.0.0.0:4567", "0.0.0.0:5678",
                                "/x/tls/tls.crt", "/x/tls/tls.key")


def _containers(objs):
    for o in objs:
        spec = o.get("spec", {}).get("template", {}).get("spec", {})
        for c in spec.get("containers", []):
            yield o, c


@pytest.mark.parametrize("values", sorted(VALUES))
def test_every_env_name_is_a_registered_knob(values):
    names = {e["name"] for _o, c in _containers(objects(VALUES[values]))
             for e in c.get("env", [])}
    assert names
    assert names <= set(contracts.ENV_KNOB_BY_NAME), \
        names - set(contracts.ENV_KNOB_BY_NAME)


def test_the_image_env_names_are_registered_knobs():
    text = open(os.path.join(REPO, "docker", "Dockerfile.vgpu")).read()
    env = re.search(r"^ENV (.*?)(?:\n(?!\s)|\Z)", text, re.M | re.S).group(1)
    names = set(re.findall(r"([A-Z_][A-Z0-9_]*)=", env)) - {"PYTHONPATH"}
    assert names and names <= set(contracts.ENV_KNOB_BY_NAME), names


@pytest.fixture
def port_vendor():
    device.init_default_devices()
    yield
    device.reset_registry()


def _h100_chips(n=8):
    return [ChipInfo(uuid=f"GPU-{i:08d}-0000-0000-0000-000000000000",
                     index=i, type=H100, hbm_mb=81559,
                     device_paths=[f"/dev/nvidia{i}"], numa=HGX_NUMA[i])
            for i in range(n)]


def test_mounts_are_what_allocate_names(tmp_path, port_vendor):
    """The plugin started from the chart's argv (its shim dir and socket
    dir moved under tmp_path through the chart's values) answers Allocate;
    every host path of the response lies in a hostPath volume the plugin
    container mounts at that same path, and those volumes are all the
    plugin needs besides the kubelet's socket dir and /dev."""
    shim = str(tmp_path / "vgpu")
    objs = objects({"devicePlugin": {"shimHostDir": shim,
                                     "socketDir": str(tmp_path / "dp")}})
    args = _parse("device-plugin", deploy.daemon_argv(objs, "device-plugin"))
    config = PluginConfig(device_split_count=args.device_split_count,
                          shim_host_dir=args.shim_host_dir,
                          socket_dir=args.socket_dir)
    os.makedirs(args.socket_dir)
    server.install_shim_artifacts(config.shim_host_dir)
    # a license makes Allocate name the validator and the license too
    os.makedirs(os.path.join(shim, "license"))
    open(os.path.join(shim, "license", "license"), "w").write("x")
    client = FakeKubeClient()
    client.add_node("n0")
    lib = FakeNvmlLib(chips=_h100_chips())
    plugin = server.GPUDevicePlugin(lib, config, client, "n0")
    plugin.start(register_with_kubelet=False)
    try:
        Registrar(lib, plugin.rm, client, "n0").register_once()
        sched = Scheduler(client)
        sched.register_from_node_annotations_once()
        pod = {"metadata": {"name": "p", "namespace": "default",
                            "uid": "uid-p", "annotations": {}},
               "spec": {"containers": [{"name": "c", "resources": {
                   "limits": {api.RESOURCE_GPU: 1,
                              api.RESOURCE_MEM: 4096}}}]},
               "status": {"phase": "Pending"}}
        client.add_pod(pod)
        winner, failed = sched.filter(client.get_pod("default", "p"))
        assert winner == "n0", failed
        sched.bind("default", "p", "n0")
        (placed,) = codec.decode_pod_devices(client.get_pod(
            "default", "p")["metadata"]["annotations"][api.TO_ALLOCATE_ANNO])
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            resp = dp_grpc.DevicePluginStub(ch).Allocate(
                pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(
                        devicesIDs=[f"{placed[0].uuid}::0"])]))
        sched.stop()
    finally:
        plugin.stop()
    (ctr,) = resp.container_responses
    mounts = {m.container_path: m.host_path for m in ctr.mounts}
    assert mounts[api.CONTAINER_SHIM_PATH] == os.path.join(shim,
                                                           "libvgpu.so")
    assert mounts[api.LD_SO_PRELOAD_PATH] == os.path.join(shim,
                                                          "ld.so.preload")
    ds = next(o for o in objs if o["kind"] == "DaemonSet")
    volumes = {v["name"]: v["hostPath"]["path"]
               for v in ds["spec"]["template"]["spec"]["volumes"]
               if "hostPath" in v}
    plugin_mounts = {m["name"]: m["mountPath"] for m in deploy.container(
        objs, "device-plugin")["volumeMounts"]}
    used = set()
    for host in mounts.values():
        hit = [n for n, path in volumes.items()
               if host == path or host.startswith(path.rstrip("/") + "/")]
        assert len(hit) == 1, (host, volumes)
        assert plugin_mounts[hit[0]] == volumes[hit[0]], hit
        # the plugin made each file it names; the node's lock dir is the
        # chart's DirectoryOrCreate volume
        assert os.path.exists(host) or host == api.LOCK_DIR, host
        used.add(hit[0])
    assert set(volumes) - used == {"device-plugin-dir", "dev"}
    assert volumes["device-plugin-dir"] == args.socket_dir
    assert deploy.container(objs, "monitor")["volumeMounts"] == [
        {"name": "shim-dir", "mountPath": shim}]


# ---------------------------------------------------------------------------
# RBAC
# ---------------------------------------------------------------------------

#: each KubeClient verb: (API group, resource, verb) it needs
KUBE_VERBS = {
    "get_node": ("", "nodes", "get"), "list_nodes": ("", "nodes", "list"),
    "patch_node_annotations": ("", "nodes", "patch"),
    "update_node_annotations_guarded": ("", "nodes", "update"),
    "get_pod": ("", "pods", "get"),
    "list_pods_all_namespaces": ("", "pods", "list"),
    "list_pods_on_node": ("", "pods", "list"),
    "list_pods_with_version": ("", "pods", "list"),
    "watch_pods": ("", "pods", "watch"),
    "patch_pod_annotations": ("", "pods", "patch"),
    "patch_pods_annotations_bulk": ("", "pods", "patch"),
    "bind_pod": ("", "pods/binding", "create"),
    "delete_pod": ("", "pods", "delete"),
    "get_lease": ("coordination.k8s.io", "leases", "get"),
    "create_lease": ("coordination.k8s.io", "leases", "create"),
    "update_lease_guarded": ("coordination.k8s.io", "leases", "update"),
}


def test_every_kubeclient_verb_is_mapped():
    verbs = {n for n in vars(clientmod.KubeClient)
             if not n.startswith("_") and callable(
                 getattr(clientmod.KubeClient, n))}
    assert verbs == set(KUBE_VERBS)


@pytest.mark.parametrize("verb", sorted(KUBE_VERBS))
@pytest.mark.parametrize("account", ["scheduler", "node"])
def test_rbac_grants_every_kubeclient_verb(verb, account):
    objs = objects()
    full = f"{deploy.RELEASE}-vgpu"
    sa = f"{full}-{account}"
    granted = set()
    roles = {o["metadata"]["name"]: o for o in objs
             if o["kind"] == "ClusterRole"}
    for b in objs:
        if b["kind"] != "ClusterRoleBinding" or not any(
                s["name"] == sa for s in b["subjects"]):
            continue
        role = roles.get(b["roleRef"]["name"])
        if role is None:
            continue  # a built-in role (system:kube-scheduler)
        for rule in role["rules"]:
            for g in rule["apiGroups"]:
                for r in rule["resources"]:
                    for v in rule["verbs"]:
                        granted.add((g, r, v))
    assert KUBE_VERBS[verb] in granted


def test_the_leases_are_granted():
    (bus,) = [o for o in objects() if o["kind"] == "ClusterRole"
              and o["metadata"]["name"].endswith("annotation-bus")]
    (lease,) = [r for r in bus["rules"]
                if r["apiGroups"] == ["coordination.k8s.io"]]
    assert lease["resources"] == ["leases"]
    assert set(lease["verbs"]) == {"get", "create", "update"}


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def example_pods():
    """(file, pod, expectation) of every pod the examples make: a Pod as
    it is, a Deployment's template once per replica."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "examples", "gpu",
                                              "*.yaml"))):
        text = open(path).read()
        headers = re.split(r"^---$", text, flags=re.M)
        for doc, head in zip(deploy.load_yaml(text), headers):
            m = re.search(r"^# expect: (placed|refused \((.+)\))$", head,
                          re.M)
            assert m, (path, head[:80])
            expect = "placed" if m.group(1) == "placed" else m.group(2)
            if doc["kind"] == "Pod":
                pods = [doc]
            else:
                tmpl = doc["spec"]["template"]
                pods = [{"metadata": dict(
                    tmpl["metadata"], name=f"{doc['metadata']['name']}-{i}"),
                    "spec": tmpl["spec"]}
                    for i in range(doc["spec"]["replicas"])]
            for i, pod in enumerate(pods):
                out.append(pytest.param(pods[:i + 1], expect, id=(
                    f"{os.path.basename(path)}:{pod['metadata']['name']}")))
    return out


def test_every_example_has_a_counterpart():
    jax = {os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "examples", "*.yaml"))}
    port = {os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "examples", "gpu", "*.yaml"))}
    assert jax - {"multihost-slice.yaml"} <= port
    assert "multicard-numa.yaml" in port


def _two_h100_nodes(client):
    for n in ("n0", "n1"):
        devs = [DeviceInfo(id=f"GPU-{n}-{i}", index=i, count=10,
                           devmem=81559, devcore=100, type=H100,
                           numa=HGX_NUMA[i], mesh=None) for i in range(8)]
        client.add_node(n, annotations={
            api.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
            api.NODE_REGISTER_ANNO: codec.encode_node_devices(devs),
            api.NODE_HOST_MEM_ANNO: "65536"})


async def _place(pods, client, sched):
    """Each pod through /webhook, the apiserver, /filter and (placed)
    /bind, as kube-scheduler and Allocate drive them: the answers."""
    http = TestClient(TestServer(build_app(sched)))
    await http.start_server()
    out = []
    try:
        for pod in pods:
            pod = json.loads(json.dumps(pod))
            pod["metadata"].update(namespace="default",
                                   uid=f"uid-{pod['metadata']['name']}")
            pod["metadata"].setdefault("annotations", {})
            pod["status"] = {"phase": "Pending"}
            resp = await http.post("/webhook", json={
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {"uid": "r", "operation": "CREATE",
                            "object": pod}})
            review = (await resp.json())["response"]
            assert review["allowed"], review
            apply_patch(pod, json.loads(base64.b64decode(review["patch"])))
            assert pod["spec"]["schedulerName"] == api.SCHEDULER_NAME
            client.add_pod(pod)
            name = pod["metadata"]["name"]
            resp = await http.post("/filter", json={
                "Pod": client.get_pod("default", name),
                "NodeNames": ["n0", "n1"]})
            body = await resp.json()
            out.append(body)
            if body.get("NodeNames"):
                node = body["NodeNames"][0]
                resp = await http.post("/bind", json={
                    "PodName": name, "PodNamespace": "default",
                    "PodUID": pod["metadata"]["uid"], "Node": node})
                assert await resp.json() == {"Error": ""}
                # what Allocate leaves
                sched.committer.drain()
                client.patch_pod_annotations("default", name, {
                    api.BIND_PHASE_ANNO: "success"})
                nodelock.release_node(client, node)
    finally:
        await http.close()
    return out


@pytest.mark.parametrize("pods,expect", example_pods())
def test_example_pod_is_placed_or_refused(pods, expect, port_vendor):
    """On two empty 8-card H100 nodes, a replica's siblings before it
    placed first: the pod goes through /webhook and /filter and is placed,
    or refused on every node for the reason its header states."""
    client = FakeKubeClient()
    _two_h100_nodes(client)
    sched = Scheduler(client)
    sched.register_from_node_annotations_once()
    try:
        answers = asyncio.new_event_loop().run_until_complete(
            _place(pods, client, sched))
    finally:
        sched.stop()
    body = answers[-1]
    if expect == "placed":
        assert body.get("NodeNames"), body
    else:
        assert not body.get("NodeNames"), body
        reasons = body.get("FailedNodes") or {}
        assert set(reasons) == {"n0", "n1"}, body
        assert all(expect in why for why in reasons.values()), body


# ---------------------------------------------------------------------------
# the image and the entry points
# ---------------------------------------------------------------------------

DOCKERFILE = os.path.join(REPO, "docker", "Dockerfile.vgpu")


def _copies():
    text = open(DOCKERFILE).read().replace("\\\n", " ")
    return [line.split()[1:] for line in text.splitlines()
            if line.startswith("COPY ")]


def test_every_copy_source_exists():
    copies = _copies()
    assert copies
    for args in copies:
        if args[0].startswith("--from="):
            # a stage's output: what vtpu_torch/native.py builds there
            names = {os.path.basename(a) for a in args[1:-1]}
            assert names == {"libvgpu.so", "libvgpucore.so",
                             "vgpu-validator", "ld.so.preload"}
            continue
        for src in args[:-1]:
            assert os.path.exists(os.path.join(REPO, src)), src


def test_the_image_installs_no_torch():
    text = open(DOCKERFILE).read()
    installs = " ".join(re.findall(r"pip install ([^\n]+)", text))
    assert {"aiohttp", "grpcio", "protobuf", "prometheus-client"} <= set(
        installs.split())
    assert not re.search(r"\b(torch|jax|triton|nvidia-)", installs)
    assert re.search(r'^ENTRYPOINT \["python"\]$', text, re.M)
    assert "FROM python:3.12-slim AS shimbuild" in text
    # the builder stage builds through native.py with gcc, no toolkit
    assert "native.interposer()" in text and "cuda" not in re.search(
        r"apt-get install[^\n]*\n[^\n]*", text).group(0)


def test_daemon_entry_points_load_no_torch_jax_or_vtpu():
    code = ("import sys, vtpu_torch.plugin.__main__, "
            "vtpu_torch.monitor.__main__, vtpu_torch.scheduler.__main__; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'vtpu')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_values_table_is_the_values_file():
    """docs/gpu/config.md lists every leaf value with its default."""
    (vals,) = deploy.load_yaml(open(os.path.join(
        deploy.CHART_DIR, "values.yaml")).read())

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict) and v and k != "nodeSelector":
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v

    doc = open(os.path.join(REPO, "docs", "gpu", "config.md")).read()
    rows = dict(re.findall(r"^\| `([a-z][\w.]*)` \| `(.*)` \|$", doc, re.M))
    assert rows == {k: json.dumps(v) for k, v in flat(vals)}
