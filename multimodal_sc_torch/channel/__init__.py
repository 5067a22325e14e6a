from multimodal_sc_torch.channel.digital import (
    bits_from_indices,
    bits_to_qpsk,
    index_bits,
    indices_from_bits,
    indices_to_qpsk,
    qpsk_ber_awgn_theory,
    qpsk_soft_bits,
    qpsk_to_bits,
    qpsk_to_indices,
)
from multimodal_sc_torch.channel.fec import (
    hamming74_block_error_theory,
    hamming74_decode,
    hamming74_decode_soft,
    hamming74_encode,
)
from multimodal_sc_torch.channel.harq import (
    crc_append,
    crc_check,
    crc_matrix,
    harq_transmit,
)
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
           "power_normalize_masked", "rate_mask", "rayleigh", "rician",
           "bits_from_indices", "bits_to_qpsk", "index_bits",
           "indices_from_bits", "indices_to_qpsk", "qpsk_ber_awgn_theory",
           "qpsk_soft_bits", "qpsk_to_bits", "qpsk_to_indices",
           "hamming74_block_error_theory", "hamming74_decode",
           "hamming74_decode_soft", "hamming74_encode", "crc_append",
           "crc_check", "crc_matrix", "harq_transmit"]
