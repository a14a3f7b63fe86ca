"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is `jax`, `jaxlib`, `flax` or
`veloslam_tpu`; the reference and the generator load nothing of the
port either; and no file of the benchmark names the root scripts."""

import os
import subprocess
import sys

import pytest

from slambench.lib import registry

ROOT = registry.REPO_ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
{extra}
top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(" ".join(top))
"""


def _top_level(mods, extra=""):
    code = PROBE.format(root=ROOT, mods=mods, extra=extra)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_entries_and_metrics_load_no_jax():
    extra = ("from slambench.lib import registry\n"
             "b = registry.benchmark()\n"
             "for w in b['workloads']:\n"
             "    t = registry.traffic(registry.workload(w['name'])"
             "['traffic'])\n"
             "    registry.entry(t['entry'])\n"
             "for m in b['per_layer']:\n"
             "    registry.metric(m['name'])\n")
    top = _top_level(["slambench.run", "slambench.lib.trace"], extra)
    assert "veloslam_tpu_torch" in top          # the entries load the port
    assert not top & {"jax", "jaxlib", "flax", "veloslam_tpu"}


@pytest.mark.parametrize("mods", [
    ["slambench.reference.check", "slambench.reference.frames",
     "slambench.reference.truth", "slambench.reference.world"],
    ["slambench.gen.drive", "slambench.gen.files"],
])
def test_reference_and_generator_load_nothing_of_the_port(mods):
    top = _top_level(mods)
    assert not top & {"jax", "jaxlib", "flax", "veloslam_tpu",
                      "veloslam_tpu_torch"}


def test_no_root_script_is_named():
    banned = ("bench.py", "bench_torch", "chip_smoke", "scripts/",
              "import scripts", "from scripts")
    for dirpath, _, names in os.walk(registry.BENCH_DIR):
        if "tests" in dirpath.split(os.sep):
            continue
        for n in names:
            if n.endswith(".py"):
                text = open(os.path.join(dirpath, n)).read()
                for b in banned:
                    assert b not in text.replace("bench.py's", ""), (n, b)
