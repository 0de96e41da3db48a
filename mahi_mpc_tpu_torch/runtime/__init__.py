from .plan import Plan, empty_plan
from .generate import ModelGenerator, generate_model
from .control import ModelControl, SolveStats
from .batch_service import BatchModelControl

__all__ = [
    "Plan", "empty_plan",
    "ModelGenerator", "generate_model",
    "ModelControl", "SolveStats",
    "BatchModelControl",
]
