from .ngp import contract_to_unisphere, spherical_harmonics_deg4, trunc_exp
from .tensorf import CPLevel, TensoCPRadianceField, hat_basis

__all__ = [
    "CPLevel",
    "TensoCPRadianceField",
    "contract_to_unisphere",
    "hat_basis",
    "spherical_harmonics_deg4",
    "trunc_exp",
]
