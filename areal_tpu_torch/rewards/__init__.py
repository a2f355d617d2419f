"""Reward computation: the local math verifier and the local code runner
(copies of ``areal_tpu/rewards/{math,code}_verify.py``)."""
