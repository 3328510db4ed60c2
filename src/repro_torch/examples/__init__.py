"""The port's counterparts of the six ``examples/*.py`` quickstarts: one
module each, under the reference's names, with its flags and defaults
(``python -m repro_torch.examples.<name>``). They run on the card unless
given ``--device cpu``; ``main(argv)`` takes the flags as a list."""
