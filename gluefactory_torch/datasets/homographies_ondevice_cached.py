"""Registry alias of the cached-feature engine
(``homographies_ondevice.OnDeviceCachedFeatureDataset``)."""

from .homographies_ondevice import OnDeviceCachedFeatureDataset

__main_dataset__ = OnDeviceCachedFeatureDataset
