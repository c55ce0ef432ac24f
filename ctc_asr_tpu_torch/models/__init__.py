"""Acoustic models: conv/dense frontend + (bi)LSTM / GRU / tanh-RNN stack
+ dense head, as plain functions on a flat parameter dict in the
reference's layouts."""

from .encoder import apply_encoder, init_params, init_shapes, output_lengths

__all__ = ["apply_encoder", "init_params", "init_shapes",
           "output_lengths"]
