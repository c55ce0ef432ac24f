"""Numeric ops of the port: device dispatch, greedy decode, the plain
prefix beam search (``beam``), the n-gram LMs (``lm``), and the wrappers
of the hand-written CUDA kernels (``stft_cuda``, ``lstm_cuda``,
``gru_cuda``, ``ctc_cuda``, ``beam_cuda``; sources in ``csrc/``, built by
``build`` at first use).

Nothing is imported here: the kernel modules build and load their
library only when a CUDA tensor first reaches them.
"""
