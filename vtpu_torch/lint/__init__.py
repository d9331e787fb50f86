"""The port's static analysis: ``python -m vtpu_torch.lint``.

The counterpart of the JAX package's two lint commands, hack/vtpulint.py
(the per-file rules VTPU001-018) and hack/vtpucheck (the registry rules
VTPU019-024), in one command over the port's tree:

* ``rules``     — the per-file AST rules, the VTPU006 shared-region ABI
                  diff, the VTPU011 hot-path scan of libvgpu.c and the C
                  half of VTPU014;
* ``engine``    — the guarded-by/confined-to engine that runs the
                  GuardRule/StoreRule entries of vtpu_torch/contracts.py;
* ``wire``      — VTPU019/020: naked wire literals, unregistered env
                  knobs and annotation writer confinement;
* ``docsync``   — VTPU021/022: docs/gpu/config.md's env table and the
                  generated docs/gpu/protocols.md;
* ``killedges`` — VTPU023: every declared crash edge has a tagged test
                  or a registry waiver;
* ``stale``     — VTPU024: every inline waiver still suppresses something.

docs/gpu/static-analysis.md has the rule table in CUDA terms.
"""
