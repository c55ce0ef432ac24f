"""ctc_asr_tpu_torch — the PyTorch/CUDA port of ``ctc_asr_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``ctc_asr_tpu`` is the reference; this package mirrors
its layout module for module and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy
and never ``jax``; from the reference it reuses only the JAX-free
modules (``config``, ``text``, ``audio``, ``metrics`` and
``data.{manifest,loader,synth}``).

This slice is the serving path (inference only): wav -> log-mel ->
conv + (bi)LSTM encoder -> greedy CTC decode, behind ``cli evaluate``
and ``cli transcribe``.

Layout
------
- ``features``    framing / log-mel / MFCC / normalization / wire decode
- ``models``      SAME conv, dense, (bi)LSTM, encoder (JAX layouts kept)
- ``ops``         device dispatch, greedy decode, the hand-written CUDA
                  kernels' wrappers (``stft_cuda``, ``lstm_cuda``)
- ``csrc``        CUDA C++ sources of those kernels, built at first use
- ``checkpoint``  reads the reference's flat-npz checkpoints
- ``evaluate`` / ``transcribe`` / ``cli``  the serving drivers
"""

__version__ = "0.1.0"
