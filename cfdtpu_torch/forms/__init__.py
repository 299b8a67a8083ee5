from .navier_stokes import StabilizedNSForm, StabilizedNSFormBDF2
from . import facet_terms

__all__ = ["StabilizedNSForm", "StabilizedNSFormBDF2", "facet_terms"]
