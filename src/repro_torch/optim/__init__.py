from .optimizers import (adafactor_init, adafactor_update, adamw_init,
                         adamw_update, clip_by_global_norm, global_norm,
                         make_optimizer, tree_leaves, tree_map,
                         warmup_cosine)

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "global_norm",
           "warmup_cosine", "make_optimizer", "tree_leaves", "tree_map"]
