"""Runtime of the port: the train loop, serving, the straggler watchdog."""
from .serve_loop import Request, Server
from .train_loop import FaultInjector, TrainSettings, make_train_step, train
from .watchdog import StepTimer, StragglerWatchdog

__all__ = ["FaultInjector", "Request", "Server", "StepTimer",
           "StragglerWatchdog", "TrainSettings", "make_train_step", "train"]
