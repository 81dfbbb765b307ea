"""Multi-process runs of the PyTorch port (the counterpart of
``semanticsegmentationactivelearning_tpu.parallel``'s data-parallel
part; spatial sharding is not ported, ROADMAP.md "Not to port")."""

from .distributed import (active, all_gather_rows, all_reduce_grads,
                          all_reduce_sum, batches, broadcast_str,
                          check_batch_divisible, initialize_distributed,
                          is_main, launched, process_count, process_index,
                          process_shard, shutdown, sync_processes)

__all__ = ["active", "all_gather_rows", "all_reduce_grads", "all_reduce_sum",
           "batches", "broadcast_str", "check_batch_divisible",
           "initialize_distributed", "is_main", "launched", "process_count",
           "process_index", "process_shard", "shutdown", "sync_processes"]
