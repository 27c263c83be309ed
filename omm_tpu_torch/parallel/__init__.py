from .shard import (classify_item_sharded, make_mesh,
                    sharded_bake_step, sharded_classify_batch,
                    sharded_group_resolve)

__all__ = ["classify_item_sharded", "make_mesh", "sharded_bake_step",
           "sharded_classify_batch", "sharded_group_resolve"]
