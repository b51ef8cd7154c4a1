from .base_model import BaseModel, build_model, get_model, make_submodel

__all__ = ["BaseModel", "build_model", "get_model", "make_submodel"]
