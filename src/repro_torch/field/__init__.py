from repro_torch.field.modarith import (  # noqa: F401
    FQ, FP, GROUP_GEN, FieldSpec, NLIMB,
    add, sub, mont_mul, mont_mul_plain, inv, batch_inv, pow_const,
    to_mont, from_mont, fsum,
    limbs_to_words, words_to_limbs,
    encode_int, encode_ints, encode_i64, decode, hash_to_int,
)
