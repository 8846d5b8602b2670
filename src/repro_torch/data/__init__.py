"""Input data of the paper's pipeline: the CIFAR-10 binary format and a
synthetic CIFAR-shaped task (numpy only)."""
