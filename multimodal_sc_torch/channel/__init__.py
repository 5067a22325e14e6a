from multimodal_sc_torch.channel.layer import (
    CHANNEL_KINDS,
    ChannelDraws,
    awgn,
    channel,
    channel_kwargs,
    ofdm,
    power_normalize,
    power_normalize_masked,
    rate_mask,
    rayleigh,
    rician,
)

__all__ = ["CHANNEL_KINDS", "ChannelDraws", "awgn", "channel",
           "channel_kwargs", "ofdm", "power_normalize",
           "power_normalize_masked", "rate_mask", "rayleigh", "rician"]
