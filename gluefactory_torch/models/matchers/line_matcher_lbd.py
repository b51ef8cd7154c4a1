"""The LBD line matcher under its registry name
(gluefactory_tpu/models/matchers/line_matcher_lbd.py); it lives with the
descriptor in ``lines/lbd.py``."""

from ..lines.lbd import LineMatcherLBD

__main_model__ = LineMatcherLBD
