"""The paper's instruction roofline for the port: hardware constants
(``hardware``), Eqs. 1-4 (``paper_model``), the paper's Tables 1-2
(``paper_data``), roofline assembly (``irm``), table emitters
(``report``) and the instruction counter source of the port's own CUDA
kernels, a census of their SASS (``sass_counters``).  Standard library
only, apart from ``hardware.h100_from_device``, which reads the card
through torch and ``nvidia-smi`` when it is called."""
