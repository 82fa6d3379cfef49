"""What the benchmark loads: the reference nothing of the program, and a CPU
run of the harness nothing of JAX or of the JAX package."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def loaded(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    tops = loaded("import slambench.reference.orb, slambench.reference.geometry, "
                  "slambench.reference.render_np")
    assert not tops & {"os1_tpu_torch", "os1_tpu", "jax", "jaxlib", "flax"}


def test_cpu_run_of_the_harness_loads_no_jax():
    code = (
        "import time, numpy as np\n"
        "from slambench import harness, traffic\n"
        "from slambench.tests.small import CONFIG, LIMITS, mix\n"
        "win, res, dev = harness.run_cell({'name': 'small'}, CONFIG, mix(40), 5, 1.0, False,\n"
        "    'cpu', time.time(), log=lambda m: None, limits=LIMITS)\n"
        "assert win.frames > 0\n"
        "import slambench.run as run\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n")
    tops = loaded(code)
    assert "os1_tpu_torch" in tops
    # Whole top-level names: os1_tpu_torch begins with os1_tpu.
    assert not tops & {"os1_tpu", "jax", "jaxlib", "flax"}
