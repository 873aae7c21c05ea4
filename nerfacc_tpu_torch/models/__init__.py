from .hash_encoding import HashEncoder, hash_grid_indices
from .ngp import (
    NGPRadianceField,
    contract_to_unisphere,
    spherical_harmonics_deg4,
    trunc_exp,
)
from .tensorf import CPLevel, TensoCPRadianceField, hat_basis

__all__ = [
    "CPLevel",
    "HashEncoder",
    "NGPRadianceField",
    "TensoCPRadianceField",
    "contract_to_unisphere",
    "hash_grid_indices",
    "hat_basis",
    "spherical_harmonics_deg4",
    "trunc_exp",
]
