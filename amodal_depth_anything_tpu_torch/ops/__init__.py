"""Tensor ops of the port: attention (hand-written Hopper kernel), resizes, convs, blend."""
