from .encoders import SinusoidalEncoder
from .hash_encoding import HashEncoder, hash_grid_indices
from .mlp import MLP, DNeRFRadianceField, NerfMLP, VanillaNeRFRadianceField
from .ngp import (
    NGPRadianceField,
    contract_to_unisphere,
    spherical_harmonics_deg4,
    trunc_exp,
)
from .tensorf import CPLevel, TensoCPRadianceField, hat_basis

__all__ = [
    "CPLevel",
    "DNeRFRadianceField",
    "HashEncoder",
    "MLP",
    "NGPRadianceField",
    "NerfMLP",
    "SinusoidalEncoder",
    "TensoCPRadianceField",
    "VanillaNeRFRadianceField",
    "contract_to_unisphere",
    "hash_grid_indices",
    "hat_basis",
    "spherical_harmonics_deg4",
    "trunc_exp",
]
