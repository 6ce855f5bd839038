from .fasta import (
    read_fasta,
    write_fasta,
    seq_to_codes,
    codes_to_bytes,
    BASE_A,
    BASE_T,
    BASE_C,
    BASE_G,
    BASE_N,
)
