"""DAB transmission-mode constants (ETSI EN 300 401).

Re-design of the mode parameter table of the reference receiver
(sdr-j-dab, ``gui.cpp:1328-1372``) and the global rate constants
(``includes/dab-constants.h:79``).  Everything here is a *spec* constant,
usable inside ``jax.jit`` traces as static Python values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

#: Fixed complex baseband input rate for every DAB front-end (samples/s).
INPUT_RATE = 2_048_000
#: Occupied RF bandwidth of a DAB ensemble (Hz).
BANDWIDTH = 1_536_000

#: Service kinds (reference: ``dab-constants.h`` AUDIO/PACKET/UNKNOWN_SERVICE).
AUDIO_SERVICE = 0o101
PACKET_SERVICE = 0o102
UNKNOWN_SERVICE = 0o100

#: Audio coding flavours (reference: ``dab-constants.h`` DAB / DAB_PLUS).
DAB = 0o100       # classic DAB, MPEG-1/2 layer II
DAB_PLUS = 0o101  # DAB+, HE-AAC in superframes

#: A Capacity Unit is 64 bits (reference: ``msc-handler.cpp:42`` CUSize=4*16).
CU_BITS = 64
#: CIF size in CUs / bits (ETSI EN 300 401 5.3; ``msc-handler.cpp:52``).
CIF_CUS = 864
CIF_BITS = CIF_CUS * CU_BITS  # 55296


@dataclasses.dataclass(frozen=True)
class DabParams:
    """Per-transmission-mode OFDM geometry.

    Mirrors the semantics of the reference's ``DabParams`` struct
    (``gui.cpp:1328-1372``); field meanings:

    * ``L``            total OFDM symbols per frame (incl. phase-reference symbol)
    * ``K``            active carriers
    * ``T_null``       null-symbol duration, samples
    * ``T_F``          frame duration, samples
    * ``T_s``          data-symbol duration (useful + guard), samples
    * ``T_u``          useful (FFT) part, samples
    * ``T_g``          guard length, samples
    * ``carrier_diff`` carrier spacing in Hz
    """

    mode: int
    L: int
    K: int
    T_null: int
    T_F: int
    T_s: int
    T_u: int
    T_g: int
    carrier_diff: int

    @property
    def bits_per_symbol(self) -> int:
        """Soft bits produced per data symbol (2 bits/carrier, DQPSK)."""
        return 2 * self.K

    @property
    def data_symbols(self) -> int:
        """Number of DQPSK data symbols per frame (excludes the PRS)."""
        return self.L - 1

    @property
    def fic_symbols(self) -> int:
        """Data symbols carrying the FIC.

        Modes I/II/IV: 3 symbols (the reference feeds symbols 1..3,
        ofdm-processor.cpp:421-429).  Mode III: 8 symbols — one 3072-bit
        codeword of 4 FIBs per 24 ms frame at 384 bits/symbol (EN 300
        401 §11.2; the reference cannot decode Mode III at all,
        fic-handler.cpp:131-141)."""
        return 8 if self.mode == 3 else 3

    @property
    def blocks_per_cif(self) -> int:
        """MSC data symbols per CIF (reference: ``msc-handler.cpp:62-71``;
        Mode III from the frame geometry: (153-1-8) symbols / 1 CIF)."""
        return {1: 18, 2: 72, 3: 144, 4: 36}[self.mode]

    @property
    def cifs_per_frame(self) -> int:
        return {1: 4, 2: 1, 3: 1, 4: 2}[self.mode]

    @property
    def msc_symbols(self) -> int:
        """Data symbols per frame carrying the MSC."""
        return self.L - 1 - self.fic_symbols


#: Transmission modes I..IV (all four decode end to end; the reference
#: rejects Mode III, fic-handler.cpp:131-141).
MODES: Dict[int, DabParams] = {
    1: DabParams(mode=1, L=76, K=1536, T_null=2656, T_F=196608,
                 T_s=2552, T_u=2048, T_g=504, carrier_diff=1000),
    2: DabParams(mode=2, L=76, K=384, T_null=664, T_F=49152,
                 T_s=638, T_u=512, T_g=126, carrier_diff=4000),
    3: DabParams(mode=3, L=153, K=192, T_null=345, T_F=49152,
                 T_s=319, T_u=256, T_g=63, carrier_diff=2000),
    4: DabParams(mode=4, L=76, K=768, T_null=1328, T_F=98304,
                 T_s=1276, T_u=1024, T_g=252, carrier_diff=2000),
}


def get_mode(mode: int) -> DabParams:
    if mode not in MODES:
        raise ValueError(f"unknown DAB transmission mode {mode}")
    return MODES[mode]


#: Band III channel plan 5A..13F (centre frequencies, Hz) — the reference
#: carries this table in ``gui.cpp:396-456``.
BAND_III: Dict[str, int] = {
    "5A": 174_928_000, "5B": 176_640_000, "5C": 178_352_000, "5D": 180_064_000,
    "6A": 181_936_000, "6B": 183_648_000, "6C": 185_360_000, "6D": 187_072_000,
    "7A": 188_928_000, "7B": 190_640_000, "7C": 192_352_000, "7D": 194_064_000,
    "8A": 195_936_000, "8B": 197_648_000, "8C": 199_360_000, "8D": 201_072_000,
    "9A": 202_928_000, "9B": 204_640_000, "9C": 206_352_000, "9D": 208_064_000,
    "10A": 209_936_000, "10B": 211_648_000, "10C": 213_360_000, "10D": 215_072_000,
    "11A": 216_928_000, "11B": 218_640_000, "11C": 220_352_000, "11D": 222_064_000,
    "12A": 223_936_000, "12B": 225_648_000, "12C": 227_360_000, "12D": 229_072_000,
    "13A": 230_784_000, "13B": 232_496_000, "13C": 234_208_000,
    "13D": 235_776_000, "13E": 237_488_000, "13F": 239_200_000,
}

#: L-Band channel plan LA..LP (reference ``gui.cpp:437-456``).
L_BAND: Dict[str, int] = {
    chr(ord("A") + i): 1_452_960_000 + i * 1_712_000 for i in range(16)
}
L_BAND = {f"L{k}": v for k, v in L_BAND.items()}
