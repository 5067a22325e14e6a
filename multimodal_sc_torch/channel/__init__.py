from multimodal_sc_torch.channel.layer import (
    CHANNEL_KINDS,
    awgn,
    channel,
    channel_kwargs,
    power_normalize,
)

__all__ = ["CHANNEL_KINDS", "awgn", "channel", "channel_kwargs",
           "power_normalize"]
