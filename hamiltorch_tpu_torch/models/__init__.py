from .bnn import (
    build_model,
    define_model_log_prob,
    define_model_prior_and_lik,
    define_model_tree_log_prob,
    define_split_model_log_prob,
    gaussian_prior_log_prob,
    log_likelihood,
    predict_model,
    sample_model,
    sample_split_model,
)
from .cnn_lstm import cnn_lstm_imdb
from .resnet_frn import FilterResponseNorm, resnet20_frn_swish

# the JAX package's list, in its order, then the port's own models
__all__ = [
    "build_model",
    "define_model_log_prob",
    "define_model_prior_and_lik",
    "define_model_tree_log_prob",
    "define_split_model_log_prob",
    "gaussian_prior_log_prob",
    "log_likelihood",
    "predict_model",
    "sample_model",
    "sample_split_model",
    "FilterResponseNorm",
    "resnet20_frn_swish",
    "cnn_lstm_imdb",
]
