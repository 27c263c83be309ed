"""The plain reference that decides `correct`: numpy and PyTorch, no
import of the program.  `levels` picks each triangle's subdivision
level, `classify` its micro-triangle states, `finalize` the bake's
serialized result."""
