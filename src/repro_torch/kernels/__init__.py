"""Hand-written Hopper kernels of the port, built from the sources here at
first use (`_build`); nothing here compiles or imports a GPU toolchain when
the package is imported."""
