"""Data: CIFAR-10 sources, the index sampler and loader, on-device preprocessing."""
