"""The benchmark's plain reference of one HoneyBadgerBFT epoch.

Plain Python and NumPy, written from the protocol's description and the
byte formats the benchmark fixes; it imports nothing of the program and
takes nothing the program made except the outputs it judges.  From the
inputs the benchmark made (the seed, the roster, the transactions and the
order they were submitted in) it works out again the dealt keys, the
batches the commit rule gives, the Reed-Solomon shards and Merkle roots
of each proposal, the common coin's tosses and the threshold decryption
of each ciphertext.

- ``gf256``: GF(2^8) tables and the systematic Reed-Solomon code.
- ``merkle``: the SHA-256 Merkle root with domain-separated leaves and
  nodes.
- ``threshold``: the 256-bit group, the trusted dealer, the coin and
  the hashed-ElGamal decryption.
- ``ledger``: the transaction-list and ciphertext codecs, the payload
  framing and the queues and commit rule of a lockstep epoch.
"""
