"""The plain reference: float32 PyTorch, TF32 off, importing nothing of the
program under test (``model.py``, ``adamw.py``, ``train.py``)."""
