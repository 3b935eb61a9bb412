from glom_tpu_torch.data.prefetch import prefetch_to_device
from glom_tpu_torch.data.synthetic import gaussian_dataset, shapes_dataset

__all__ = ["gaussian_dataset", "prefetch_to_device", "shapes_dataset"]
