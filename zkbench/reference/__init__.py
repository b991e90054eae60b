"""The plain reference that decides `correct`: a STARK verifier, claim
digests and secp256k1 in plain Python and numpy.  It imports nothing of
the program under test."""
