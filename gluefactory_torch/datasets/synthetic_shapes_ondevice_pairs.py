"""Registry name of the two-view synthetic-shapes engine
(gluefactory_tpu/datasets/synthetic_shapes_ondevice_pairs.py): see
``synthetic_shapes_ondevice.OnDeviceSyntheticShapesPairsDataset``."""

from .synthetic_shapes_ondevice import OnDeviceSyntheticShapesPairsDataset

__main_dataset__ = OnDeviceSyntheticShapesPairsDataset
