from baton_tpu_torch.models.bert import BertConfig, bert_classifier_model
from baton_tpu_torch.models.cnn import cnn_mnist_model
from baton_tpu_torch.models.linear import linear_regression_model
from baton_tpu_torch.models.mlp import mlp_classifier_model
from baton_tpu_torch.models.resnet import resnet18_cifar_model, resnet_model

__all__ = [
    "BertConfig",
    "bert_classifier_model",
    "cnn_mnist_model",
    "linear_regression_model",
    "mlp_classifier_model",
    "resnet18_cifar_model",
    "resnet_model",
]
