"""Registry alias of the cached-wireframe engine
(``homographies_ondevice.OnDeviceCachedWireframeDataset``)."""

from .homographies_ondevice import OnDeviceCachedWireframeDataset

__main_dataset__ = OnDeviceCachedWireframeDataset
