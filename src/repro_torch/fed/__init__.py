"""The model market: client local training and evaluation."""
from repro_torch.fed.client import evaluate_cnn, local_train, local_train_group
from repro_torch.fed.market import build_market, build_market_grouped, market_eval_fn

__all__ = [
    "local_train",
    "local_train_group",
    "evaluate_cnn",
    "build_market",
    "build_market_grouped",
    "market_eval_fn",
]
