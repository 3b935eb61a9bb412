from glom_tpu_torch.data.loaders import file_dataset, image_folder_dataset, npy_dataset
from glom_tpu_torch.data.prefetch import prefetch_to_device
from glom_tpu_torch.data.synthetic import gaussian_dataset, shapes_dataset, write_shapes_dataset

__all__ = [
    "file_dataset",
    "gaussian_dataset",
    "image_folder_dataset",
    "npy_dataset",
    "prefetch_to_device",
    "shapes_dataset",
    "write_shapes_dataset",
]
