"""mcgaze_tpu_torch: MCGaze video gaze estimation in PyTorch with
hand-written CUDA kernels for the H100, ported from the JAX package
mcgaze_tpu (which stays as the reference). Imports no JAX.

Public surface (inference):
    ModelConfig, MCGazeModel, init_model   — the model
    VideoGazeEvaluator, EvalConfig         — batched clip evaluation
    gaze_error, evaluate_results           — offline MAE scoring
"""
__version__ = '0.1.0'

from .evaluation.driver import EvalConfig, VideoGazeEvaluator  # noqa: F401
from .evaluation.mae import evaluate_results, gaze_error  # noqa: F401
from .models.mcgaze import MCGazeModel, ModelConfig, init_model  # noqa: F401
