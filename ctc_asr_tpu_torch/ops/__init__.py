"""Numeric ops of the port: device dispatch, greedy decode, and the
wrappers of the hand-written CUDA kernels (``stft_cuda``, ``lstm_cuda``,
``ctc_cuda``; sources in ``csrc/``, built by ``build`` at first use).

Nothing is imported here: the kernel modules build and load their
library only when a CUDA tensor first reaches them.
"""
