"""The model market: client local training and evaluation."""
