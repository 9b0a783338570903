"""Model zoo of the PyTorch port: registry specs (the JAX package's wire
format) dispatch to ``nn.Module`` models. Ported: ``transformer_lm`` and
``transformer_classifier``."""

from .base import softmax_xent
from .registry import build_registry_spec, model_from_json, register_model
from .transformer import TransformerClassifier, TransformerLM

__all__ = ["build_registry_spec", "model_from_json", "register_model",
           "softmax_xent", "TransformerClassifier", "TransformerLM"]
