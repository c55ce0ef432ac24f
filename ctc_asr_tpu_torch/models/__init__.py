"""Acoustic models: conv/dense frontend + (bi)LSTM / GRU / tanh-RNN stack
+ dense head, or the Conformer (``models.conformer``), as plain functions
on a flat parameter dict in the reference's layouts."""

from .encoder import (apply_encoder, init_params, init_shapes, init_state,
                      output_lengths, state_shapes)

__all__ = ["apply_encoder", "init_params", "init_shapes", "init_state",
           "output_lengths", "state_shapes"]
