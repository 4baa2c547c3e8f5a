from .inference import Predictor, ProposalPredictor
from .postprocess import FinalDetections, PostprocessConfig, postprocess_image
from .voc_eval import OpensetVocEvaluator, voc_ap
from .coco_eval import OpensetCocoEvaluator
from .os_cocoeval import OpenSetCocoEval
from .testing import inference_on_dataset, proposal_ar_on_dataset
from .proposals import evaluate_box_proposals
