"""Entry points (counterpart of ``repro.launch``): ``train`` is the LM
training front door."""
