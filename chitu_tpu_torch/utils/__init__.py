from chitu_tpu_torch.utils.logging import init_logger, get_logger
from chitu_tpu_torch.utils.timers import ProfilerSession, Timers, get_timers
from chitu_tpu_torch.utils.device import resolve_device
