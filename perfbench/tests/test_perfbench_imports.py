"""The import check, in a fresh interpreter: nothing the harness or the
reference loads has the top-level name ``jax``, ``jaxlib``, ``flax`` or
``openset_rcnn_tpu`` (whole names: ``openset_rcnn_tpu_torch`` is not
``openset_rcnn_tpu``), and the reference loads nothing of
``openset_rcnn_tpu_torch``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LOADED = "import json, sys; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"


def _top_level(imports: str):
    code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; {LOADED}"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _top_level(
        "import perfbench.harness.core, perfbench.harness.prepare, perfbench.harness.compare, perfbench.calibrate; "
        "from perfbench.harness import specs; [specs.entry(e) for e in ('train_loop', 'eval_loop', 'frame_loop')]; "
        "[specs.metric_reader(m['name']) for m in specs.benchmark()['per_layer']]; "
        "import openset_rcnn_tpu_torch.engine.train_state, openset_rcnn_tpu_torch.evaluation.testing, "
        "openset_rcnn_tpu_torch.engine.train_loop")
    assert "openset_rcnn_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "openset_rcnn_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level("import perfbench.reference.model, perfbench.reference.data.order, "
                        "perfbench.reference.evaluation.voc_eval, perfbench.reference.data.categories")
    assert not loaded & {"jax", "jaxlib", "flax", "openset_rcnn_tpu", "openset_rcnn_tpu_torch"}


def test_reference_sources_name_no_program_import():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "openset_rcnn_tpu" not in s and "jax" not in s.split(), (path, s)
