"""Operations and bytes of the measured work, from shapes and the plain reference."""
