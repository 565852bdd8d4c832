"""Plain references and the scenes they share with the program: plain
PyTorch and numpy, importing nothing of the program."""
