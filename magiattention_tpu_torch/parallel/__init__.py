"""Attention baselines beside the CP runtime: NSA (native sparse
attention) on one device."""

from .nsa import init_nsa_params, nsa_attn, params_from_numpy  # noqa: F401

__all__ = ["init_nsa_params", "nsa_attn", "params_from_numpy"]
