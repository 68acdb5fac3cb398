"""Models of the port: functions on nested dicts of ``torch.Tensor``."""
