"""Sparse matrix containers and host-side tooling.

Formats (parity with /root/reference/include/type-defs.h:15-62 plus two
device execution formats that the serial reference has no analog of):

- ``COO``  — triplet assembly format            (reference type-defs.h:26-35)
- ``CSR``  — canonical compressed-sparse-row    (reference type-defs.h:15-24)
- ``BSR``  — uniform block CSR, row-major dense blocks for batched GEMM
             (reference stores column-major "as Fortran", type-defs.h:45-55;
             we keep row-major because jnp/einsum batched GEMM is row-major)
- ``ELL``  — padded ELLPACK, the gather-SpMV execution format
- ``DIA``  — diagonal storage, the stencil-matrix execution format
- ``HYB``  — band + remainder hybrid for nearly-banded general matrices
"""

from lssp_tpu.sparse.types import COO, CSR, BSR, ELL, DIA, HYB
from lssp_tpu.sparse.convert import (
    coo_to_csr, csr_to_coo, csr_to_bsr, bsr_to_csr, csr_to_ell, csr_to_dia,
    csr_to_hyb, to_device_format,
)
from lssp_tpu.sparse.utils import (
    sort_columns, is_sorted, transpose, adjust_zero_diag, block_diag_extract,
    diagonal, split_lu, split_ldu,
)
from lssp_tpu.sparse.generators import (
    laplacian_2d, laplacian_3d, convection_diffusion_2d, elasticity_2d,
    anisotropic_poisson_2d, random_sparse,
)
from lssp_tpu.sparse.io import read_matrix_market, write_matrix_market

__all__ = [
    "COO", "CSR", "BSR", "ELL", "DIA", "HYB",
    "coo_to_csr", "csr_to_coo", "csr_to_bsr", "bsr_to_csr", "csr_to_ell",
    "csr_to_dia", "csr_to_hyb", "to_device_format",
    "sort_columns", "is_sorted", "transpose", "adjust_zero_diag",
    "block_diag_extract", "diagonal", "split_lu", "split_ldu",
    "laplacian_2d", "laplacian_3d", "convection_diffusion_2d",
    "elasticity_2d", "anisotropic_poisson_2d", "random_sparse",
    "read_matrix_market", "write_matrix_market",
]
