"""The plain reference: NumPy only.  It imports nothing of the program
(neither the port nor the JAX package) and reads only what the benchmark's
generators made: the CSR arrays, x and b.  Whatever the program derives
from them (packs, the Jacobi diagonal) it works out again here."""
