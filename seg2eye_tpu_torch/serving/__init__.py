"""Serving artifacts of the port (counterpart of ``seg2eye_tpu/serving``):
batch-polymorphic ``torch.export`` programs that ``load_serving`` runs
without the model code."""
from seg2eye_tpu_torch.serving.export import (FORMAT_VERSION, ServingModel,
                                              export_inference,
                                              export_refiner, load_serving)

__all__ = ["FORMAT_VERSION", "ServingModel", "export_inference",
           "export_refiner", "load_serving"]
