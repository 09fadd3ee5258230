"""The model zoo under the JAX package's names
(``paule_tpu/models/__init__.py``), as ``torch.nn.Module``s whose
parameters are named as the JAX parameter trees.

The reference-name aliases name the port's modules (the JAX package's name
the function pairs of its blocks).  Not in the port: the ``*_init``
aliases, which have no counterpart where a module initialises itself.
"""

from . import blocks, torch_convert  # noqa: F401
from .baselines import LinearModel, NonLinearModel  # noqa: F401
from .blocks import (  # noqa: F401
    MelChannelConv as MelChannelConv1D,
    TimeConvInceptionBlock as TimeConvIncpetionBlock,
    TimeConvResBlock,
)
from .classifier import (  # noqa: F401
    LinearClassifier,
    SpeechNonSpeechTransformer,
    TransformerEncoderLayer as CustomTransformerEncoderLayer,
    positional_encoding as PositionalEncoding,
)
from .embedder import (  # noqa: F401
    EmbeddingModel, MelEmbeddingModelMelSmoothResidualUpsampling)
from .forward import (  # noqa: F401
    ForwardModel, ForwardModelMelTimeSmoothResidual)
from .generative import (  # noqa: F401
    Critic,
    Generator,
    LSTMCritic,
    LSTMGenerator,
    SemVecToCpModel,
    SemVecToMelModel,
)
from .inverse import InverseModelMelTimeSmoothResidual  # noqa: F401
from ..ops.derivatives import (  # noqa: F401
    add_vel_and_acc_info, double_sequence)


def time_conv_Allx1(channels):
    """``Conv1d(ch, ch, 1)`` (the reference's factory)."""
    return blocks.Conv1d(channels, channels, 1)


def time_conv_1x3(channels):
    """Channelwise ``Conv1d(ch, ch, 3, groups=ch)``."""
    return blocks.Conv1d(channels, channels, 3, groups=channels)


def time_conv_1x5(channels):
    """Channelwise ``Conv1d(ch, ch, 5, groups=ch)``."""
    return blocks.Conv1d(channels, channels, 5, groups=channels)
