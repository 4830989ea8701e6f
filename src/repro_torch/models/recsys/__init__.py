"""Recsys models of the port: the multi-hot embedding layer (K7) and AutoInt."""
