"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole), and the reference nothing of the port; without a card
``run.py`` fails and prints no result."""

import json
import subprocess
import sys

from port_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "vn_pointcloudcompletion_tpu"}

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", LOADED.format(root=str(harness.ROOT),
                                                              imports=imports)],
                         capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded("import port_bench.harness, port_bench.modes.train, port_bench.modes.serve, "
                   "port_bench.control\nport_bench.harness.readers()")
    assert not names & FORBIDDEN
    assert "vn_pointcloudcompletion_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded("import port_bench.reference.steps, port_bench.reference.flagship, "
                   "port_bench.reference.vn_pointr, port_bench.check, port_bench.counts.flagship, "
                   "port_bench.counts.vn_pointr_448, port_bench.traffic, port_bench.weights")
    assert not names & (FORBIDDEN | {"vn_pointcloudcompletion_tpu_torch"})


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "flagship-train-b8", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vn_pointcloudcompletion_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vn_pointcloudcompletion_tpu.models", sys)
    assert harness.forbidden_modules() == ["vn_pointcloudcompletion_tpu"]
