"""The PyTorch port imports neither JAX nor the JAX package, nor ``cv2`` or
``PIL`` (the GPU machine has neither): the transforms import them inside the
functions that decode and resize."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import openset_rcnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "flax" or m.startswith("flax.")
             or m == "openset_rcnn_tpu" or m.startswith("openset_rcnn_tpu.")
             or m == "cv2" or m.startswith("cv2.") or m == "PIL" or m.startswith("PIL."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    # a fresh interpreter: this test process has imported jax via conftest
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split("\n")[:2]
    assert int(n_modules) >= 50, out.stdout
    assert bad == "", f"the port loaded {bad}"
