"""Spine straightening and de-pedicle masking: the offline preprocessing
that turns a raw CT and its vertebra mask into straightened crops."""

from .curve import Interpolator, frenet_serret, sagittal_basis  # noqa: F401
