"""PyTorch + CUDA port of the UDA aerial segmentation framework.

This package is the Hopper (NVIDIA H100) counterpart of the JAX package
``uda_aerial_semantic_segmentation_research_tpu``, which stays the
numerical reference.  It imports ``torch`` only -- never JAX, and nothing
of the JAX package -- and keeps its own copies of what it needs.

Ported so far: the serving path (U-Net eval forward -> ``predict_batch``
/ ``predict_raster``) with its hand-written CUDA kernel
``ops.conv_bn_relu``.  Public functions keep the JAX package's NHWC
layout; entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
