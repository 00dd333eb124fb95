"""PyTorch/CUDA port of celestia_app_tpu's block encode-and-commit path and
its proof and read plane.

blobs -> ``da.square.build`` -> ``da.dah.shares_to_ods`` ->
``da.dah.new_dah_from_ods``: 2D Reed-Solomon extension, NMT axis roots and
the data root, on an NVIDIA H100 through two hand-written CUDA kernels
(``csrc/sha256.cu``, ``csrc/rs_extend.cu``). On the same kernels:
``da.edscache`` (the block cache), ``da.proof_device`` (share, tx and cell
proofs from row trees computed once on the card), ``da.commitment_device``
(batched blob commitments) and ``da.namespace_device`` (batched namespace
reads). The package imports torch and
numpy, never jax and nothing of ``celestia_app_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor every
kernel wrapper takes its plain PyTorch version.
"""
