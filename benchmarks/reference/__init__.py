"""The benchmark's plain reference of Zero-TIG: PyTorch float32, TF32 off,
on ``F.conv2d`` and torch operations. It imports nothing of the program
under test and takes nothing the program made: the benchmark hands it the
same state dict and frames it hands the program."""

from .model import ZeroTIGReference
from .ops import exact_f32
from .params import ALIASES, PARAMS, TRAINABLE, WIDTHS, check_widths, full_state
from .train import TrainerReference, zero_tig_loss

__all__ = ["ALIASES", "PARAMS", "TRAINABLE", "WIDTHS", "TrainerReference", "ZeroTIGReference", "check_widths",
           "exact_f32", "full_state", "zero_tig_loss"]
