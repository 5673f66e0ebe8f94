"""Inference entry points of the PyTorch port."""

from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
    create_colored_mask,
    create_overlay,
    load_class_dict,
    predict_batch,
    predict_mask,
    predict_raster,
    test_model,
)

__all__ = ["create_colored_mask", "create_overlay", "load_class_dict", "predict_batch",
           "predict_mask", "predict_raster", "test_model"]
