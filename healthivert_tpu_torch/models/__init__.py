"""Spectral-norm conv blocks, the two-stage generator, generator_forward,
and the model registry of the command line.

The registry is the counterpart of healthivert_tpu/models/__init__.py: a
model name maps to its CLI flag injector (base_options.py:79-88). The port
has one model, pix2pix; its flag defaults are `pix2pix.option_setter`.
"""

from __future__ import annotations


def get_option_setter(name: str):
    if name != "pix2pix":
        raise KeyError(f"unknown model '{name}'; available: ['pix2pix']")
    from .pix2pix import option_setter

    return option_setter
