from .cart import Binner, CartConfig, FlatTree, Tree, TreeNode, grow_tree
from .gradient_boosting import GradientBoosting, GradientBoostingConfig
from .random_forest import RandomForest, RandomForestConfig

__all__ = [
    "Binner", "CartConfig", "FlatTree", "Tree", "TreeNode", "grow_tree",
    "GradientBoosting", "GradientBoostingConfig",
    "RandomForest", "RandomForestConfig",
]
