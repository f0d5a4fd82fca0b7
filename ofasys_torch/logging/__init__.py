from ofasys_torch.logging.meters import AverageMeter, MetersDict, StopwatchMeter, SumMeter, TimeMeter

__all__ = ["AverageMeter", "SumMeter", "TimeMeter", "StopwatchMeter", "MetersDict"]
