"""Observability of the PyTorch port: TensorBoard event files written
without the ``tensorboard`` package, prediction overlays and figures drawn
in numpy."""
