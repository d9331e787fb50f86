"""The GPU node's Grafana dashboards against the JAX package's.

``docs/gpu/dashboard.json`` and ``deploy/grafana/gpu-shim-profile.json``
(item 19) are the twins of ``docs/tpu-dashboard.json`` and
``deploy/grafana/shim-profile.json``: panel for panel the same titles in
GPU words, types, grid positions, units, thresholds, legends and refIds,
each expression the JAX one with every family renamed through the maps of
the port's exporters (``vtpu_torch/dashboards.py``). Every selector names
a sample the port's collectors serve, built here on fakes, each exporter
in a process of its own so that no label this test adds reaches another
test's registry.

F15, a deliberate difference: seven JAX selectors name a counter family
without the ``_total`` that ``prometheus_client`` serves, so their panels
are always empty. The JAX collectors show it (the JAX selectors are held to
the JAX package's exposition here); the twins add the suffix.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from vtpu_torch import dashboards, deploy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [("docs/tpu-dashboard.json", "docs/gpu/dashboard.json"),
         ("deploy/grafana/shim-profile.json",
          "deploy/grafana/gpu-shim-profile.json")]
IDS = ["overview", "shim-profile"]

#: F15: the JAX selectors that name a counter family without ``_total``,
#: and the twins' selectors
F15 = {"vTPU_container_program_launches":
       "vGPU_container_program_launches_total",
       "vTPU_container_oom_events": "vGPU_container_oom_events_total",
       "vTPUHostMemOOMEvents": "vGPUHostMemOOMEvents_total",
       "vTPUHostQuotaOver": "vGPUHostQuotaOver_total",
       "vTPUHostQuotaBlocked": "vGPUHostQuotaBlocked_total",
       "vTPUHostQuotaUnblocked": "vGPUHostQuotaUnblocked_total",
       "vTPUShimQuotaPressure": "vGPUShimQuotaPressure_total"}

TPU_WORDS = ("vTPU", "HBM", "TPU", "tensorcore")
#: a JAX title's words for a TPU node and the GPU node's
TITLE_WORDS = (("HBM", "GPU memory"), ("tensorcore", "SM"), ("TPU", "GPU"))
#: the note of the change that added a JAX row (an upper-case word and
#: its number), which its twin leaves out
ROW_NOTE = re.compile(r"\b[A-Z]{2,5} \d+(?:, | )")


def load(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


# the exporters' expositions, each built on fakes in a process of its own;
# every labelled family of the process's registry that holds no child is
# given one, so that each family shows the samples it would serve
TOUCH = """
from prometheus_client import REGISTRY, generate_latest
from prometheus_client.metrics import MetricWrapperBase


def touch():
    for c in list(REGISTRY._collector_to_names):
        if (isinstance(c, MetricWrapperBase) and c._labelnames
                and not c._metrics):
            c.labels(*["x"] * len(c._labelnames))


def done():
    touch()
    print(generate_latest(REGISTRY).decode())
"""

PORT_MONITOR = TOUCH + """
import ctypes, os, tempfile
import vtpu_torch.monitor.__main__  # the daemon's registry
from vtpu_torch.enforce import region
from vtpu_torch.enforce.region import SharedRegion
from vtpu_torch.monitor.metrics import MonitorCollector
from vtpu_torch.monitor.pathmonitor import ContainerRegions
from vtpu_torch.plugin.nvml import ChipInfo, FakeNvmlLib
from vtpu_torch.util.client import FakeKubeClient
from vtpu_torch.util.podcache import PodCache

CARD = "GPU-00000000-0000-0000-0000-00000000000a"
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "uid1_0"))
r = SharedRegion(os.path.join(root, "uid1_0", "vgpu.cache"))
r.configure([8 << 20], [50], priority=1, dev_uuids=[CARD])
r.configure_host(4 << 20)
r.attach()
core = region.load_core_library()       # the callsite profile, every call
core.vtpu_prof_configure.argtypes = [ctypes.c_int, ctypes.c_int]
core.vtpu_prof_flush.argtypes = [ctypes.POINTER(region.SharedRegionStruct)]
core.vtpu_prof_configure(1, 1)
assert r.try_alloc(3 << 20)
assert r.host_try_alloc(1 << 20)
assert not r.try_alloc(6 << 20)          # a refusal at the quota
core.vtpu_prof_flush(r._ptr)
client = FakeKubeClient()
client.add_pod({"metadata": {"uid": "uid1", "name": "train", "namespace":
                             "ml", "annotations": {}},
                "spec": {"nodeName": "n1", "containers": []},
                "status": {"phase": "Running"}})
cache = PodCache(client, node_name="n1")
cache.sync_once()
REGISTRY.register(MonitorCollector(
    ContainerRegions(root), gpulib=FakeNvmlLib(chips=[
        ChipInfo(uuid=CARD, index=0, hbm_mb=81559)]),
    client=client, node_name="n1", pod_cache=cache))
done()
"""

PORT_SCHEDULER = TOUCH + """
import types
import vtpu_torch.scheduler.__main__  # the daemon's registry
from vtpu_torch import device
from vtpu_torch.scheduler import Scheduler
from vtpu_torch.scheduler.metrics import SchedulerCollector
from vtpu_torch.util.client import FakeKubeClient
from tests.torch_sched_parity import cards, node_annos

device.init_default_devices()
client = FakeKubeClient()
client.add_node("n1", annotations=node_annos(cards("n1", n=2)))
sched = Scheduler(client)
sched.register_from_node_annotations_once()
sched.ha = types.SimpleNamespace(
    identity="sched-0", transitions={0: 1}, collisions={0: 0},
    is_leader=lambda: True, owned_groups=lambda: frozenset({0}))
sched._fence_generation = lambda group=0: 1
REGISTRY.register(SchedulerCollector(sched))
done()
"""

PORT_GATEWAY = TOUCH + """
import vtpu_torch.gateway.metrics
done()
"""

# the JAX package's families as its processes declare them (no sample
# needed: the TYPE line says which samples a family serves)
JAX_FAMILIES = TOUCH + """
import tempfile, types
import vtpu.gateway.metrics, vtpu.monitor.daemon, vtpu.scheduler.core, vtpu.trace
from vtpu.monitor.metrics import MonitorCollector
from vtpu.monitor.pathmonitor import ContainerRegions
from vtpu.plugin.tpulib import FakeTpuLib
from vtpu.scheduler.metrics import SchedulerCollector
from vtpu.util.client import FakeKubeClient

REGISTRY.register(MonitorCollector(
    ContainerRegions(tempfile.mkdtemp()), tpulib=FakeTpuLib(chips=[]),
    client=FakeKubeClient(), node_name="n1"))
sched = types.SimpleNamespace(
    inspect_all_nodes_usage=lambda: {},
    pods=types.SimpleNamespace(list_pods=lambda: []),
    _watch_healthy=types.SimpleNamespace(is_set=lambda: True),
    ha=types.SimpleNamespace(identity="s0", transitions={0: 1},
                             collisions={0: 0}),
    _owned_groups=lambda: frozenset({0}), _fence_generation=lambda g=0: 1)
REGISTRY.register(SchedulerCollector(sched))
done()
"""


def exposition(program: str) -> dict:
    """family -> (type, {sample name: set of label names})"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(program)],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    fams = {}
    for name, (ftype, samples) in dashboards.parse(out.stdout).items():
        names = {}
        for sname, labels, _ in samples:
            names.setdefault(sname, set()).update(labels)
        fams[name] = (ftype, names)
    return fams


@pytest.fixture(scope="module")
def served():
    """exporter -> its exposition, built on fakes"""
    from vtpu_torch import native

    native.build_all()      # the monitor's region library
    return {"monitor": exposition(PORT_MONITOR),
            "scheduler": exposition(PORT_SCHEDULER),
            "gateway": exposition(PORT_GATEWAY)}


@pytest.fixture(scope="module")
def jax_declared(tmp_path_factory):
    return exposition(JAX_FAMILIES)


def port_names() -> dict:
    """every JAX family -> the port's, over the exporters' maps"""
    names = {}
    for fams in dashboards.exporters().values():
        names.update(fams)
    return names


def rename(expr: str, name: str, new: str) -> str:
    """``expr`` with the metric name ``name`` (whole) made ``new``"""
    return re.sub(rf"(?<![A-Za-z0-9_:]){re.escape(name)}(?![A-Za-z0-9_:])",
                  new, expr)


def twin_expr(jax_expr: str) -> str:
    """a JAX expression as its twin reads: every selector's family
    renamed, its suffix kept, and ``_total`` added to the F15 ones"""
    names, out = port_names(), jax_expr
    for name in {s.name for s in dashboards.selectors(jax_expr)}:
        family, suffix = dashboards.split_sample(name, names)
        out = rename(out, name, F15.get(name, names[family] + suffix))
    return out


def twin_title(jax_title: str) -> str:
    """a JAX title in GPU words"""
    out = ROW_NOTE.sub("", jax_title)
    for tpu, gpu in TITLE_WORDS:
        out = out.replace(tpu, gpu)
    return out


def strip(panel: dict) -> dict:
    """a panel less what its twin words differently: its title and
    description, its targets' expressions and the panels a row holds"""
    out = {k: v for k, v in panel.items()
           if k not in ("title", "description", "panels")}
    out["targets"] = [{k: v for k, v in t.items() if k != "expr"}
                      for t in panel.get("targets", [])]
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_every_jax_panel_has_its_twin(pair):
    """Panel for panel, rows and their panels included: the title in GPU
    words, and the same type, grid position, units, thresholds, options,
    datasource, legends and refIds."""
    jax, gpu = (dashboards.panels(load(p)) for p in pair)
    assert len(gpu) == len(jax)
    for j, g in zip(jax, gpu):
        assert g["title"] == twin_title(j["title"])
        assert strip(g) == strip(j), j["title"]
        assert ("description" in g) == ("description" in j), j["title"]
    jd, gd = (load(p) for p in pair)
    for key in ("schemaVersion", "time", "refresh", "templating",
                "annotations", "graphTooltip", "editable", "timezone"):
        if key == "templating" and key in jd:
            for jv, gv in zip(jd[key]["list"], gd[key]["list"]):
                assert {k: v for k, v in gv.items()
                        if k not in ("definition", "query")} == {
                    k: v for k, v in jv.items()
                    if k not in ("definition", "query")}
                assert gv["query"]["refId"] == jv["query"]["refId"]
        else:
            assert gd.get(key) == jd.get(key), key


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_every_expression_is_the_jax_one_renamed(pair):
    """Each expression and template query is the JAX one with every family
    renamed through the port's maps; the F15 selectors alone also take
    ``_total``, and nothing else differs."""
    jax, gpu = (dashboards.expressions(load(p)) for p in pair)
    assert [w for w, _ in gpu] == [twin_title(w) for w, _ in jax]
    for (where, j), (_, g) in zip(jax, gpu):
        assert g == twin_expr(j), where


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_every_selector_is_a_sample_the_port_serves(pair, served):
    """Each selector of a GPU dashboard names a sample that the exporter of
    its family serves (the monitor, the scheduler or the gateway, built on
    fakes), and every label it matches on is a label of that sample; the
    ``instance`` label is the scrape's own."""
    families = dashboards.exporters()
    for where, expr in dashboards.expressions(load(pair[1])):
        for sel in dashboards.selectors(expr):
            owners = [e for e, fams in families.items()
                      if any(sel.name == f or sel.name.startswith(f + "_")
                             for f in fams.values())]
            assert owners, (where, sel.name)
            hits = [e for e in owners for _, (_, samples) in
                    served[e].items() if sel.name in samples]
            assert hits, (where, sel.name, owners)
            labels = set().union(*(
                samples[sel.name] for e in hits
                for _, (_, samples) in served[e].items()
                if sel.name in samples))
            for label, _, _ in sel.matchers:
                assert label == "instance" or label in labels, (
                    where, sel.name, label, labels)


def test_f15_the_jax_selectors_without_total_match_no_series(jax_declared):
    """Held to the JAX package's own collectors: every selector of the JAX
    dashboards names a sample its family's type serves, but for exactly
    the seven F15 names, counters named without ``_total``."""
    empty = set()
    for path, _ in PAIRS:
        for where, expr in dashboards.expressions(load(path)):
            for sel in dashboards.selectors(expr):
                family, suffix = dashboards.split_sample(sel.name,
                                                         jax_declared)
                ftype = jax_declared[family][0]
                if suffix not in dashboards.SAMPLE_SUFFIXES[ftype]:
                    assert ftype == "counter", (where, sel.name)
                    empty.add(sel.name)
    assert empty == set(F15)
    names = port_names()
    assert F15 == {j: names[j] + "_total" for j in F15}


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_no_tpu_word_is_left(pair):
    with open(os.path.join(REPO, pair[1])) as f:
        text = f.read()
    for word in TPU_WORDS:
        assert word not in text, word
    gd = load(pair[1])
    assert gd["uid"].startswith("vgpu-") and gd["title"].startswith("vGPU")


def test_the_guide_names_every_family_and_the_charts_ports():
    """docs/gpu/dashboard.md names every sample the GPU dashboards chart,
    both dashboards, and the ports and NodePorts the chart's values set."""
    with open(os.path.join(REPO, "docs", "gpu", "dashboard.md")) as f:
        text = f.read()
    names = {s.name for _, s in dashboards.dashboard_selectors()}
    assert names and not [n for n in names if n not in text]
    for path in dashboards.DASHBOARDS:
        assert path in text, path
    with open(os.path.join(deploy.CHART_DIR, "values.yaml")) as f:
        (values,) = deploy.load_yaml(f.read())
    for port in (values["scheduler"]["metricsPort"],
                 values["scheduler"]["nodePort"],
                 values["monitor"]["metricsPort"],
                 values["monitor"]["nodePort"],
                 values["monitor"]["infoPort"]):
        assert f"{port}" in text, port


@pytest.mark.parametrize("expr,want", [
    ("rate(vGPU_container_program_launches_total[5m])",
     [("vGPU_container_program_launches_total", ())]),
    ('histogram_quantile(0.99, sum by (callsite, le) (rate('
     'vGPUShimCallsiteLatency_bucket{instance=~"$node"}'
     '[$__rate_interval])))',
     [("vGPUShimCallsiteLatency_bucket", (("instance", "=~", "$node"),))]),
    ('sum(rate(vGPUShimQuotaPressure_total{kind=~"host_.*"}[5m])) by (kind)',
     [("vGPUShimQuotaPressure_total", (("kind", "=~", "host_.*"),))]),
    ("max by (podname) (vGPU_device_memory_usage_in_bytes / "
     "vGPU_device_memory_limit_in_bytes) - 1",
     [("vGPU_device_memory_usage_in_bytes", ()),
      ("vGPU_device_memory_limit_in_bytes", ())]),
    ("vGPUHostMemLimit > 0", [("vGPUHostMemLimit", ())]),
    ('sum by (instance) (rate(vGPUShimQuotaPressure_total{instance=~"$node",'
     ' kind="at_limit_ns"}[$__rate_interval])) / 1e9',
     [("vGPUShimQuotaPressure_total",
       (("instance", "=~", "$node"), ("kind", "=", "at_limit_ns")))]),
    ("label_values(vGPUShimCallsiteCalls_total, instance)",
     [("vGPUShimCallsiteCalls_total", ())]),
    ("topk(10, sum by (podnamespace, podname, callsite) "
     '(vGPUShimPodSeconds{instance=~"$node"}))',
     [("vGPUShimPodSeconds", (("instance", "=~", "$node"),))]),
])
def test_selectors_are_read_out_of_an_expression(expr, want):
    assert [tuple(s) for s in dashboards.selectors(expr)] == want


SCRAPE = """\
# HELP vGPU_device_memory_usage_in_bytes usage
# TYPE vGPU_device_memory_usage_in_bytes gauge
vGPU_device_memory_usage_in_bytes{podname="a",poduid="1"} 990.0
vGPU_device_memory_usage_in_bytes{podname="b",poduid="2"} 100.0
# HELP vGPU_device_memory_limit_in_bytes limit
# TYPE vGPU_device_memory_limit_in_bytes gauge
vGPU_device_memory_limit_in_bytes{podname="a",poduid="1"} 1000.0
vGPU_device_memory_limit_in_bytes{podname="b",poduid="2"} 0.0
# HELP vGPU_container_program_launches_total launches
# TYPE vGPU_container_program_launches_total counter
vGPU_container_program_launches_total{podname="a"} 7.0
"""


def test_the_leakage_panel_is_evaluated_by_hand():
    """usage / limit per series, the most of each pod, less 1; a limit of
    0 reads +Inf, as PromQL divides"""
    got = dashboards.leakage(SCRAPE)
    assert got["a"] == pytest.approx(-0.01)
    assert got["b"] == float("inf")
    assert dashboards.LEAKAGE_EXPR in {
        e for _, e in dashboards.expressions(load("docs/gpu/dashboard.json"))}


def test_a_scrape_is_held_to_the_selectors_it_serves(monkeypatch):
    """hold(): a declared family with a sample passes, one declared with
    none is reported unless the run fills it, and an undeclared family or
    a counter named without ``_total`` fails."""
    monkeypatch.setattr(dashboards, "dashboard_selectors", lambda: [
        ("d.json: used", dashboards.Selector(
            "vGPU_device_memory_usage_in_bytes", ())),
        ("d.json: launches", dashboards.Selector(
            "vGPU_container_program_launches_total", ())),
        ("d.json: bare", dashboards.Selector(
            "vGPU_container_program_launches", ())),
        ("d.json: ooms", dashboards.Selector(
            "vGPU_container_oom_events_total", ())),
        ("d.json: sched", dashboards.Selector("vGPUDeviceMemoryLimit", ()))])
    lines, failures = dashboards.hold(SCRAPE, "monitor", filled=())
    assert [f.split(": ")[1] for f in failures] == ["bare", "ooms"]
    assert any("launches_total: 1 samples, 1 matching" in t for t in lines)
    text = SCRAPE + ("# HELP vGPU_container_oom_events_total ooms\n"
                     "# TYPE vGPU_container_oom_events_total counter\n")
    lines, failures = dashboards.hold(text, "monitor", filled=())
    assert [f.split(": ")[1] for f in failures] == ["bare"]
    assert any("oom_events_total: declared, no sample" in t for t in lines)
    _, failures = dashboards.hold(
        text, "monitor", filled={"vGPU_container_oom_events"})
    assert [f.split(": ")[1] for f in failures] == ["bare", "ooms"]
