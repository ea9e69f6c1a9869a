from repro_torch.field.modarith import (  # noqa: F401
    FQ, FP, GROUP_GEN, FieldSpec, NLIMB,
    add, sub, neg, mont_mul, mont_mul_plain, inv, batch_inv, pow_const,
    to_mont, from_mont, is_zero, eq, fsum,
    int_to_limbs, ints_to_limbs, limbs_to_ints,
    limbs_to_words, words_to_limbs,
    encode_int, encode_ints, encode_i64, decode, decode_centered,
    rand_elements, hash_to_int,
)
