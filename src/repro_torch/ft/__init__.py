"""repro_torch.ft -- fault tolerance: the fault-tolerant training driver
(:mod:`.driver`) and the work-stealing cluster scheduler of the streaming
server (:mod:`.scheduler`)."""
from .driver import DriverConfig, FailureInjector, TrainDriver
from .scheduler import WorkStealingScheduler

__all__ = ["TrainDriver", "DriverConfig", "FailureInjector",
           "WorkStealingScheduler"]
