from .tree_2d import VascularTree2D

__all__ = ["VascularTree2D"]
