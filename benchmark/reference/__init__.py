"""The plain reference: the extended data square, its NMT axis roots and
its data root, written again in plain torch (any device) and numpy. It
imports neither the program (celestia_app_tpu_torch) nor its JAX
original, and takes nothing the program made: only the ODS."""
