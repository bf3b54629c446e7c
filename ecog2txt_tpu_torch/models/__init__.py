"""Model cores (functional: explicit parameter trees + apply functions)."""

from .beam import beam_decode  # noqa: F401

from .conformer import (  # noqa: F401
    ConformerConfig,
    ConformerStream,
    conformer_encode,
    init_conformer,
    receptive_field_steps,
)
from .seq2seq import (  # noqa: F401
    AuxHead,
    Seq2SeqConfig,
    decode_from_encoder,
    decoder_teacher_forcing,
    encode,
    greedy_decode,
    init_seq2seq,
    seq2seq_loss,
)
