"""Model zoo of the PyTorch port: registry specs (the JAX package's wire
format) dispatch to ``nn.Module`` models — ``transformer_lm``,
``transformer_classifier``, ``transformer_moe_lm``, ``resnet`` /
``resnet50`` and ``rnn_classifier`` / ``rnn_lm`` — and :mod:`.presets`
builds the reference examples' graph specs."""

from . import presets
from .base import softmax_xent
from .moe import MoETransformerLM
from .registry import build_registry_spec, model_from_json, register_model
from .resnet import ResNet, ResNet50
from .rnn import RNNLM, RNNClassifier
from .transformer import TransformerClassifier, TransformerLM

__all__ = ["build_registry_spec", "model_from_json", "register_model",
           "presets", "softmax_xent", "MoETransformerLM", "ResNet",
           "ResNet50", "RNNClassifier", "RNNLM", "TransformerClassifier",
           "TransformerLM"]
