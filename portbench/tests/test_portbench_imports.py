"""The harness loads no JAX: a subprocess (pytest's own process has jax,
from the root conftest) imports and runs a tiny cell on the CPU and lists
every loaded module whose top-level name is exactly jax, jaxlib, flax or
ngp_tpu; the reference's files import nothing of the port."""

import json
import re
import subprocess
import sys

from portbench.harness.spec import BENCH_DIR, ROOT

SCRIPT = r"""
import json, sys, pathlib
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench.harness import scene
scene.SCENE_CACHE = pathlib.Path({cache!r})
from portbench.harness.cell import run_cell
from portbench.tests.tiny import shrink, tiny_cell
out = run_cell(tiny_cell("oadd-train-800"), 5, 0.2, False, 0.0, device="cpu", tweak=shrink)
import run as entry
print(json.dumps({{"correct": out["correct"], "found": entry.forbidden_modules(),
                  "port": "ngp_tpu_torch" in sys.modules}}))
"""


def test_no_jax_in_a_run(tmp_path):
    code = SCRIPT.format(root=str(ROOT), cache=str(tmp_path / "scene"))
    env_path = str(BENCH_DIR)
    proc = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {env_path!r}); " + code],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["found"] == [] and res["port"] and res["correct"]


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, str(BENCH_DIR))
    import run as entry

    saved = dict(sys.modules)
    try:
        for m in list(sys.modules):
            if m.split(".", 1)[0] in entry.FORBIDDEN:
                del sys.modules[m]
        sys.modules["ngp_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake"] = sys
        assert entry.forbidden_modules() == []
        sys.modules["ngp_tpu.ops"] = sys
        assert entry.forbidden_modules() == ["ngp_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_port():
    pat = re.compile(r"^\s*(from|import)\s+(ngp_tpu_torch|ngp_tpu|jax)\b", re.M)
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert not pat.search(path.read_text()), path
