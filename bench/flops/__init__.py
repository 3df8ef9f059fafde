"""Model FLOPs of one training step, one module a model family
(``flops/<family>.py``): matrix products 6 x parameters x tokens with only
the active experts counted, plus causal attention; recompute not counted."""
