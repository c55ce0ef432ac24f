"""ctc_asr_tpu_torch — the PyTorch/CUDA port of ``ctc_asr_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``ctc_asr_tpu`` is the reference; this package mirrors
its layout module for module and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch``, numpy and
scipy, never ``jax`` and nothing of ``ctc_asr_tpu``: what it needs from
the reference's JAX-free modules it keeps as its own copies under the
same names (``config``, ``text``, ``audio``, ``metrics``, ``data``,
``utils``, ``ops/lm``). Config files, checkpoints, manifests and LM
files are shared formats: either package reads what the other writes.

Three slices are ported: serving (wav -> log-mel -> conv + (bi)LSTM
encoder -> greedy CTC decode, behind ``cli evaluate`` and ``cli
transcribe``), training (CTC loss, LSTM BPTT, Adam, the train loop and
its checkpoints, behind ``cli train``) and beam decoding (prefix beam
search with char-LM shallow fusion and word-LM N-best rescoring, behind
``decode.method=beam``, with ``cli train-lm``).

Layout
------
- ``config``      the frozen config tree, presets, JSON, CLI overrides
- ``text`` / ``audio`` / ``metrics``  vocabulary, wav I/O, WER / CER
- ``data``        manifests, the bucketed loader, the synthetic corpus
- ``features``    framing / log-mel / MFCC / normalization / wire decode,
                  SpecAugment
- ``models``      init, SAME conv, dense, dropout, (bi)LSTM, encoder
                  (JAX layouts kept)
- ``ops``         device dispatch, greedy decode, plain beam search, the
                  n-gram LMs, and the hand-written CUDA kernels'
                  wrappers (``stft_cuda``, ``lstm_cuda``, ``ctc_cuda``,
                  ``beam_cuda``)
- ``csrc``        CUDA C++ sources of those kernels, built at first use
- ``optim``       global-norm clipping, Adam / AdamW, LR schedules
- ``parallel``    data parallelism across processes: the process grid,
                  the ``torch.distributed`` group, the gradient all-reduce
- ``checkpoint``  the reference's flat-npz checkpoints, read and written
- ``train`` / ``evaluate`` / ``transcribe`` / ``cli``  the entry points
"""

__version__ = "0.1.0"
