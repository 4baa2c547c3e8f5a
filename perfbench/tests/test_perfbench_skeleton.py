"""The reference's module tree of each configuration, pinned: the ordered
state-dict leaves with their shapes, the weight recipe's plan and the
seeded weights, as they were when each trunk was still named in
``reference/models/detector.py``. A trunk found by name builds the same
detector, and the same weights load into it."""
import hashlib

import pytest
import torch

from perfbench.harness import specs
from perfbench.harness.weights import leaf_plan, make_weights
from perfbench.reference.model import skeleton

SEED = 1234
PINNED = {
    "r50_fpn_bf16": {
        "leaves": 302,
        "names": "822a7a6e4100ed422d8d79d29ec1352f662e65bbda7c578c94dcd7bbf3182e2b",
        "plan": "1271183a9e593dc49577a8a95995a35e3c6282ec59569977cd19228e0de62a2f",
        "weights": "2090d30c7fa51260f3408ebc0c3447a3602c179f550b93a9ff6543247914ee3d",
    },
    "vitdet_b_fpn": {
        "leaves": 198,
        "names": "046c90a96176cece0b8f5ef52f6d662da3f8a941e17a931f61a772a8f740a122",
        "plan": "73a689fa3734780414adf39e483990e2467f79a60b166136f40e94229d61aaa3",
        "weights": "c559936e05684e7cf48b34df65a15ec9171eb18d7d1cc49e7c308874e08ad33c",
    },
}


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_skeleton_and_weights_are_pinned(name):
    config = specs.config(name)
    model = skeleton(config["cfg"])
    leaves = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    order = ["backbone", "fpn", "rpn_head", "box_head", "box_predictor", "pln", "classifier"]
    assert [n for n, _ in model.named_children()] == [n for n in order if getattr(model, n) is not None]
    want = PINNED[name]
    assert len(leaves) == want["leaves"]
    assert _sha(repr(leaves)) == want["names"]
    assert _sha(repr(leaf_plan(model, config["weights"]["rules"]))) == want["plan"]
    weights = make_weights(model, config["weights"]["rules"], SEED, torch.device("cpu"))
    h = hashlib.sha256()
    for k, v in weights.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == want["weights"]
