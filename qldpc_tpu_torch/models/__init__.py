from .bb import BBCode, CODE_REGISTRY, get_code
from .circuit import SyndromeCircuit
from .builder import build_decoding_matrices, channel_llrs
