from .navier_stokes import (StabilizedNSForm, StabilizedNSFormBDF2,
                            StabilizedNSFormCurlCurl)
from . import facet_terms

__all__ = ["StabilizedNSForm", "StabilizedNSFormBDF2",
           "StabilizedNSFormCurlCurl", "facet_terms"]
