"""dabjax — a DAB/DAB+ software-radio framework in JAX, whose accelerator is
an NVIDIA H100 (XLA and one CUDA Viterbi kernel).

Brand-new implementation with the capabilities of the reference receiver
sdr-j-dab (AlbrechtL/sdr-j-dab): OFDM synchronization and demodulation,
FIC/MSC channel decoding, DAB (MP2) and DAB+ (AAC superframe) audio, and
PAD/MOT/packet data services — re-architected as block-batched, functionally
pure pipelines over sharded time-block tensors.
"""

from dabjax.constants import DabParams, MODES, get_mode, INPUT_RATE

__version__ = "0.1.0"
