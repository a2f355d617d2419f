"""Training: micro-batch packing and the one-device train engine."""
