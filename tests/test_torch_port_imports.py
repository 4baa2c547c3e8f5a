"""The PyTorch port imports neither JAX, Flax, Orbax nor the JAX package,
nor ``cv2``, ``PIL`` or ``tensorboardX`` (the GPU machine need not have
them): the transforms, the predict tool and the visualizer import the first
two inside the functions that decode, resize and draw, ``EventWriter`` the
third when it opens its writer. Every module is imported, the training CLI
``openset_rcnn_tpu_torch.train``, the tools, the weight converters and the
visualizer among them."""
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
             or m == "flax" or m.startswith("flax.") or m == "orbax" or m.startswith("orbax.")
             or m == "openset_rcnn_tpu" or m.startswith("openset_rcnn_tpu.")
             or m == "cv2" or m.startswith("cv2.") or m == "PIL" or m.startswith("PIL.")
             or m == "tensorboardX" or m.startswith("tensorboardX."))
assert {"openset_rcnn_tpu_torch.train", "openset_rcnn_tpu_torch.engine.checkpoint",
        "openset_rcnn_tpu_torch.engine.events", "openset_rcnn_tpu_torch.utils.torch_weights",
        "openset_rcnn_tpu_torch.utils.visualizer", "openset_rcnn_tpu_torch.tools.predict",
        "openset_rcnn_tpu_torch.tools.export_serving", "openset_rcnn_tpu_torch.tools.convert_checkpoint"} <= set(names)
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
