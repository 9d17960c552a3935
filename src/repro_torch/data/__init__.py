from repro_torch.data.pipeline import (SyntheticLMDataset, TokenStream,
                                       make_batches, pack_documents,
                                       shard_batch)

__all__ = ["SyntheticLMDataset", "TokenStream", "make_batches",
           "pack_documents", "shard_batch"]
