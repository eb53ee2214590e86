"""The host pack engines (the port's own copy of the JAX package's
``pack/``): the fused resident-x pack, the classic GStream pack, row
balancing, the layout model's rate tables, and the final-level builders."""
