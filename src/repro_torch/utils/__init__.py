from repro_torch.utils.tree import (tree_map_with_path, tree_param_count,
                                    tree_size_bytes)
