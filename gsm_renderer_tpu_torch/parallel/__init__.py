"""Band-sharded multi-device rendering on ``torch.distributed``."""
