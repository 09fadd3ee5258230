"""No run loads JAX or the JAX package; the reference loads nothing of
the program."""

import json
import os
import subprocess
import sys
import types

from portbench import run as R

ROOT = R.ROOT


def test_top_level_names_are_compared_whole(monkeypatch):
    base = R.forbidden_modules()
    for name in ("paule_tpu_torch", "paule_tpu_torch.api", "jaxtyping",
                 "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert R.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "paule_tpu.api",
                        types.ModuleType("paule_tpu.api"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert set(R.forbidden_modules()) - set(base) == {"paule_tpu", "jax"}


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import portbench.judge, portbench.yardstick.readers, "
        "portbench.yardstick.trace, portbench.plain.weights")
    assert not mods & {"paule_tpu_torch", "paule_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_whole_run_loads_no_forbidden_module():
    mods = _modules_after(
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "import tiny\n"
        "cell, window, checks = tiny.run('resynth-1s')\n"
        "assert window['attempted'] >= 1")
    assert "paule_tpu_torch" in mods
    assert not mods & set(R.FORBIDDEN)
