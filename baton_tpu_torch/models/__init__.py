from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.llama import LlamaConfig, llama_lm_model, llama_lora_target
from baton_tpu_torch.models.lora import lora_trainable, lora_wrap, merge_lora
from baton_tpu_torch.models.lstm import LSTMConfig, lstm_lm_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.models.moe import MoEConfig, moe_apply, moe_init
from baton_tpu_torch.models.resnet import resnet18_cifar_model, resnet_model
from baton_tpu_torch.models.vit import ViTConfig, vit_model

__all__ = [
    "linear_regression_model",
    "mlp_classifier_model",
    "cnn_mnist_model",
    "resnet_model",
    "resnet18_cifar_model",
    "lora_wrap",
    "lora_trainable",
    "merge_lora",
    "BertConfig",
    "bert_classifier_model",
    "LlamaConfig",
    "llama_lm_model",
    "llama_lora_target",
    "LSTMConfig",
    "lstm_lm_model",
    "MoEConfig",
    "moe_apply",
    "moe_init",
    "ViTConfig",
    "vit_model",
]
