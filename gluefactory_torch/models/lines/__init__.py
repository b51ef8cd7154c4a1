"""Line detectors and the wireframe (gluefactory_tpu/models/lines)."""
