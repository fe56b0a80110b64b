"""repro_torch.ft -- fault tolerance of the serving loop.

Only the work-stealing cluster scheduler is ported (the streaming
server's checkpointable queue); the fault tolerance of training comes
with the training slice.
"""
from .scheduler import WorkStealingScheduler

__all__ = ["WorkStealingScheduler"]
