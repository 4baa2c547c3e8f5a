from .inference import Predictor
from .postprocess import PostprocessConfig
