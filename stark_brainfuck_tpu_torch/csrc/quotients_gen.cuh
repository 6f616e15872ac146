// Generated from the models by
//   python -m stark_brainfuck_tpu_torch.ops.quotient_kernels --emit
// (ops/quotient_kernels.py): each table's Table.quotients as
// straight-line code for kernel F4 (quotients.cu) and its host
// harness. Do not edit; emit again after a change to the
// constraints.

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace {

// processor: 421 recorded operations, 188 after lowering; 21 quotients;
// a position: 195 multiplies, 61 adds, 88 subs, 22 words read, 63 written
struct QuotientsProcessor {
  static constexpr uint64_t kKey = 0x3005E70672699953ULL;
  static constexpr int kBase = 7, kExt = 4, kOutputs = 21, kUniform = 14, kParams = 0;

  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,
                            const long long* params, Xf* u) {
    (void)ch;
    (void)tm;
    (void)params;
    const Xf v19 = Xf{ch[0], ch[1], ch[2]};
    const Xf v20 = Xf{ch[3], ch[4], ch[5]};
    const Xf v21 = Xf{ch[6], ch[7], ch[8]};
    const Xf v22 = Xf{ch[9], ch[10], ch[11]};
    const Xf v23 = Xf{ch[12], ch[13], ch[14]};
    const Xf v24 = Xf{ch[15], ch[16], ch[17]};
    const Xf v25 = Xf{ch[18], ch[19], ch[20]};
    const Xf v26 = Xf{ch[21], ch[22], ch[23]};
    const Xf v27 = Xf{ch[24], ch[25], ch[26]};
    const Xf v28 = Xf{ch[27], ch[28], ch[29]};
    const Xf v29 = Xf{tm[0], tm[1], tm[2]};
    const Xf v30 = Xf{tm[3], tm[4], tm[5]};
    const Xf v31 = Xf{tm[6], tm[7], tm[8]};
    const Xf v32 = Xf{tm[9], tm[10], tm[11]};
    u[0] = v19;
    u[1] = v25;
    u[2] = v20;
    u[3] = v21;
    u[4] = v22;
    u[5] = v26;
    u[6] = v23;
    u[7] = v24;
    u[8] = v27;
    u[9] = v28;
    u[10] = v29;
    u[11] = v30;
    u[12] = v31;
    u[13] = v32;
  }

  template <class R>
  GL_FN static void row(const R& r, const Xf* u) {
    (void)u;
    const uint64_t v2 = r.base(2, 0);
    const uint64_t v33 = gl_sub(v2, 0x5BULL);
    const uint64_t v34 = gl_sub(v2, 0x5DULL);
    const uint64_t v35 = gl_sub(v2, 0x3CULL);
    const uint64_t v36 = gl_sub(v2, 0x3EULL);
    const uint64_t v37 = gl_sub(v2, 0x2CULL);
    const uint64_t v38 = gl_sub(v2, 0x2EULL);
    const uint64_t v39 = gl_sub(v2, 0x2BULL);
    const uint64_t v40 = gl_sub(v2, 0x2DULL);
    const uint64_t v41 = gl_mul(v33, v34);
    const uint64_t v42 = gl_mul(v35, v41);
    const uint64_t v43 = gl_mul(v36, v42);
    const uint64_t v44 = gl_mul(v37, v43);
    const uint64_t v45 = gl_mul(v38, v44);
    const uint64_t v46 = gl_mul(v39, v45);
    const uint64_t v47 = gl_mul(v39, v40);
    const uint64_t v48 = gl_mul(v38, v47);
    const uint64_t v49 = gl_mul(v37, v48);
    const uint64_t v50 = gl_mul(v36, v49);
    const uint64_t v51 = gl_mul(v35, v50);
    const uint64_t v52 = gl_mul(v34, v51);
    const uint64_t v5 = r.base(5, 0);
    const uint64_t v6 = r.base(6, 0);
    const uint64_t v53 = gl_mul(v5, v6);
    const uint64_t v54 = gl_sub(v53, 0x1ULL);
    const uint64_t v12 = r.base(1, 1);
    const uint64_t v1 = r.base(1, 0);
    const uint64_t v55 = gl_sub(v12, v1);
    const uint64_t v56 = gl_sub(v55, 0x2ULL);
    const uint64_t v57 = gl_mul(v5, v56);
    const uint64_t v3 = r.base(3, 0);
    const uint64_t v58 = gl_sub(v12, v3);
    const uint64_t v59 = gl_mul(v54, v58);
    const uint64_t v60 = gl_add(v57, v59);
    const uint64_t v13 = r.base(4, 1);
    const uint64_t v4 = r.base(4, 0);
    const uint64_t v61 = gl_sub(v13, v4);
    const uint64_t v14 = r.base(5, 1);
    const uint64_t v62 = gl_sub(v14, v5);
    const uint64_t v63 = gl_mul(v2, v60);
    const uint64_t v64 = gl_mul(v2, v61);
    const uint64_t v65 = gl_mul(v2, v62);
    const uint64_t v66 = gl_mul(v52, v63);
    const uint64_t v67 = gl_mul(v52, v64);
    const uint64_t v68 = gl_mul(v52, v65);
    const uint64_t v69 = gl_mul(v54, v56);
    const uint64_t v70 = gl_mul(v5, v58);
    const uint64_t v71 = gl_add(v69, v70);
    const uint64_t v72 = gl_mul(v2, v71);
    const uint64_t v73 = gl_mul(v33, v51);
    const uint64_t v74 = gl_mul(v72, v73);
    const uint64_t v75 = gl_add(v66, v74);
    const uint64_t v76 = gl_mul(v64, v73);
    const uint64_t v77 = gl_add(v67, v76);
    const uint64_t v78 = gl_mul(v65, v73);
    const uint64_t v79 = gl_add(v68, v78);
    const uint64_t v80 = gl_sub(v55, 0x1ULL);
    const uint64_t v81 = gl_add(0x1ULL, v61);
    const uint64_t v82 = gl_mul(v2, v80);
    const uint64_t v83 = gl_mul(v2, v81);
    const uint64_t v84 = gl_mul(v41, v50);
    const uint64_t v85 = gl_mul(v82, v84);
    const uint64_t v86 = gl_add(v75, v85);
    const uint64_t v87 = gl_mul(v83, v84);
    const uint64_t v88 = gl_add(v77, v87);
    const uint64_t v89 = gl_sub(v61, 0x1ULL);
    const uint64_t v90 = gl_mul(v2, v89);
    const uint64_t v91 = gl_mul(v42, v49);
    const uint64_t v92 = gl_mul(v82, v91);
    const uint64_t v93 = gl_add(v86, v92);
    const uint64_t v94 = gl_mul(v90, v91);
    const uint64_t v95 = gl_add(v94, v88);
    const uint64_t v96 = gl_sub(v62, 0x1ULL);
    const uint64_t v97 = gl_mul(v96, v2);
    const uint64_t v98 = gl_mul(v40, v45);
    const uint64_t v99 = gl_mul(v98, v82);
    const uint64_t v100 = gl_add(v93, v99);
    const uint64_t v101 = gl_mul(v98, v64);
    const uint64_t v102 = gl_add(v95, v101);
    const uint64_t v103 = gl_mul(v97, v98);
    const uint64_t v104 = gl_add(v103, v79);
    const uint64_t v105 = gl_add(0x1ULL, v62);
    const uint64_t v106 = gl_mul(v105, v2);
    const uint64_t v107 = gl_mul(v46, v82);
    const uint64_t v108 = gl_add(v100, v107);
    const uint64_t v109 = gl_mul(v46, v64);
    const uint64_t v110 = gl_add(v102, v109);
    const uint64_t v111 = gl_mul(v106, v46);
    const uint64_t v112 = gl_add(v104, v111);
    const uint64_t v113 = gl_mul(v43, v48);
    const uint64_t v114 = gl_mul(v113, v82);
    const uint64_t v115 = gl_add(v108, v114);
    const uint64_t v116 = gl_mul(v113, v64);
    const uint64_t v117 = gl_add(v110, v116);
    const uint64_t v118 = gl_mul(v44, v47);
    const uint64_t v119 = gl_mul(v118, v82);
    const uint64_t v120 = gl_add(v115, v119);
    r.store(7, Xf{gl_mul(v120, r.zinv(1)), 0, 0});
    const uint64_t v121 = gl_mul(v118, v64);
    const uint64_t v122 = gl_add(v117, v121);
    r.store(8, Xf{gl_mul(v122, r.zinv(1)), 0, 0});
    const uint64_t v123 = gl_mul(v118, v65);
    const uint64_t v124 = gl_add(v112, v123);
    r.store(9, Xf{gl_mul(v124, r.zinv(1)), 0, 0});
    const uint64_t v11 = r.base(0, 1);
    const uint64_t v0 = r.base(0, 0);
    const uint64_t v125 = gl_sub(v11, v0);
    const uint64_t v126 = gl_sub(v125, 0x1ULL);
    r.store(10, Xf{gl_mul(v126, r.zinv(1)), 0, 0});
    const uint64_t v127 = gl_mul(v5, v54);
    r.store(11, Xf{gl_mul(v127, r.zinv(1)), 0, 0});
    const uint64_t v128 = gl_mul(v6, v54);
    r.store(12, Xf{gl_mul(v128, r.zinv(1)), 0, 0});
    const Xf v129 = xf_mul_base(u[0], v1);
    const Xf v130 = xf_sub(u[1], v129);
    const Xf v131 = xf_mul_base(u[2], v2);
    const Xf v132 = xf_sub(v130, v131);
    const Xf v133 = xf_mul_base(u[3], v3);
    const Xf v134 = xf_sub(v132, v133);
    const Xf v7 = r.ext(7, 0);
    const Xf v135 = xf_mul(v134, v7);
    const Xf v15 = r.ext(7, 1);
    const Xf v136 = xf_sub(v135, v15);
    const Xf v137 = xf_mul_base(v136, v2);
    const uint64_t v138 = gl_mul(v39, v43);
    const uint64_t v139 = gl_mul(v138, v40);
    const uint64_t v140 = gl_mul(v139, v37);
    const uint64_t v141 = gl_mul(v140, v38);
    const Xf v142 = xf_sub(v7, v15);
    const Xf v143 = xf_mul_base(v142, v141);
    const Xf v144 = xf_add(v137, v143);
    r.store(13, xf_mul_base(v144, r.zinv(1)));
    const Xf v145 = xf_mul_base(u[4], v0);
    const Xf v146 = xf_sub(u[5], v145);
    const Xf v147 = xf_mul_base(u[6], v4);
    const Xf v148 = xf_sub(v146, v147);
    const Xf v149 = xf_mul_base(u[7], v5);
    const Xf v150 = xf_sub(v148, v149);
    const Xf v8 = r.ext(8, 0);
    const Xf v151 = xf_mul(v150, v8);
    const Xf v16 = r.ext(8, 1);
    const Xf v152 = xf_sub(v151, v16);
    const Xf v153 = xf_mul_base(v152, v2);
    const Xf v154 = xf_sub(v8, v16);
    const Xf v155 = xf_mul_base(v154, v141);
    const Xf v156 = xf_add(v153, v155);
    r.store(14, xf_mul_base(v156, r.zinv(1)));
    const Xf v9 = r.ext(9, 0);
    const Xf v157 = xf_mul(u[8], v9);
    const Xf v17 = r.ext(9, 1);
    const Xf v158 = xf_sub(v17, v157);
    const Xf v159 = xf_sub_base(v158, v14);
    const uint64_t v160 = gl_mul(v38, v43);
    const uint64_t v161 = gl_mul(v160, v39);
    const uint64_t v162 = gl_mul(v161, v40);
    const Xf v163 = xf_mul_base(v159, v162);
    const Xf v164 = xf_mul_base(v163, v2);
    const Xf v165 = xf_sub(v17, v9);
    const uint64_t v166 = gl_sub(0x2CULL, v2);
    const Xf v167 = xf_mul_base(v165, v166);
    const Xf v168 = xf_add(v164, v167);
    r.store(15, xf_mul_base(v168, r.zinv(1)));
    const Xf v10 = r.ext(10, 0);
    const Xf v169 = xf_mul(v10, u[9]);
    const Xf v18 = r.ext(10, 1);
    const Xf v170 = xf_sub(v18, v169);
    const Xf v171 = xf_sub_base(v170, v5);
    const uint64_t v172 = gl_mul(v39, v44);
    const uint64_t v173 = gl_mul(v172, v40);
    const Xf v174 = xf_mul_base(v171, v173);
    const Xf v175 = xf_mul_base(v174, v2);
    const Xf v176 = xf_sub(v18, v10);
    const uint64_t v177 = gl_sub(0x2EULL, v2);
    const Xf v178 = xf_mul_base(v176, v177);
    const Xf v179 = xf_add(v175, v178);
    r.store(16, xf_mul_base(v179, r.zinv(1)));
    const Xf v180 = xf_sub(u[10], v7);
    r.store(17, xf_mul_base(v180, r.zinv(2)));
    const Xf v181 = xf_sub(u[11], v151);
    const Xf v182 = xf_mul_base(v181, v2);
    const Xf v183 = xf_sub(u[11], v8);
    const Xf v184 = xf_mul_base(v183, v141);
    const Xf v185 = xf_add(v182, v184);
    r.store(18, xf_mul_base(v185, r.zinv(2)));
    const Xf v186 = xf_sub(u[12], v9);
    r.store(19, xf_mul_base(v186, r.zinv(2)));
    const Xf v187 = xf_sub(u[13], v10);
    r.store(20, xf_mul_base(v187, r.zinv(2)));
    r.store(0, Xf{gl_mul(v0, r.zinv(0)), 0, 0});
    r.store(1, Xf{gl_mul(v1, r.zinv(0)), 0, 0});
    r.store(2, Xf{gl_mul(v4, r.zinv(0)), 0, 0});
    r.store(3, Xf{gl_mul(v5, r.zinv(0)), 0, 0});
    r.store(4, Xf{gl_mul(v6, r.zinv(0)), 0, 0});
    r.store(5, xf_mul_base(v9, r.zinv(0)));
    r.store(6, xf_mul_base(v10, r.zinv(0)));
  }
};

// instruction: 110 recorded operations, 76 after lowering; 10 quotients;
// a position: 85 multiplies, 31 adds, 55 subs, 12 words read, 30 written
struct QuotientsInstruction {
  static constexpr uint64_t kKey = 0x48435CD51B2B1287ULL;
  static constexpr int kBase = 3, kExt = 2, kOutputs = 10, kUniform = 7, kParams = 0;

  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,
                            const long long* params, Xf* u) {
    (void)ch;
    (void)tm;
    (void)params;
    const Xf v10 = Xf{ch[0], ch[1], ch[2]};
    const Xf v11 = Xf{ch[3], ch[4], ch[5]};
    const Xf v12 = Xf{ch[6], ch[7], ch[8]};
    const Xf v13 = Xf{ch[18], ch[19], ch[20]};
    const Xf v14 = Xf{ch[30], ch[31], ch[32]};
    const Xf v15 = Xf{tm[0], tm[1], tm[2]};
    const Xf v16 = Xf{tm[12], tm[13], tm[14]};
    u[0] = v10;
    u[1] = v11;
    u[2] = v12;
    u[3] = v13;
    u[4] = v14;
    u[5] = v15;
    u[6] = v16;
  }

  template <class R>
  GL_FN static void row(const R& r, const Xf* u) {
    (void)u;
    const uint64_t v0 = r.base(0, 0);
    const Xf v17 = xf_mul_base(u[0], v0);
    const Xf v4 = r.ext(4, 0);
    const Xf v18 = xf_sub(v4, v17);
    const uint64_t v1 = r.base(1, 0);
    const Xf v19 = xf_mul_base(u[1], v1);
    const Xf v20 = xf_sub(v18, v19);
    const uint64_t v2 = r.base(2, 0);
    const Xf v21 = xf_mul_base(u[2], v2);
    const Xf v22 = xf_sub(v20, v21);
    r.store(1, xf_mul_base(v22, r.zinv(0)));
    const uint64_t v5 = r.base(0, 1);
    const uint64_t v23 = gl_sub(v5, v0);
    const uint64_t v24 = gl_sub(v23, 0x1ULL);
    const uint64_t v25 = gl_mul(v23, v24);
    r.store(2, Xf{gl_mul(v25, r.zinv(1)), 0, 0});
    const uint64_t v6 = r.base(1, 1);
    const uint64_t v26 = gl_sub(v2, v6);
    const uint64_t v27 = gl_mul(v23, v26);
    r.store(3, Xf{gl_mul(v27, r.zinv(1)), 0, 0});
    const uint64_t v28 = gl_sub(v6, v1);
    const uint64_t v29 = gl_mul(v24, v28);
    r.store(4, Xf{gl_mul(v29, r.zinv(1)), 0, 0});
    const uint64_t v7 = r.base(2, 1);
    const uint64_t v30 = gl_sub(v7, v2);
    const uint64_t v31 = gl_mul(v24, v30);
    r.store(5, Xf{gl_mul(v31, r.zinv(1)), 0, 0});
    const Xf v32 = xf_mul_base(u[0], v5);
    const Xf v33 = xf_sub(u[3], v32);
    const Xf v34 = xf_mul_base(u[1], v6);
    const Xf v35 = xf_sub(v33, v34);
    const Xf v36 = xf_mul_base(u[2], v7);
    const Xf v37 = xf_sub(v35, v36);
    const Xf v3 = r.ext(3, 0);
    const Xf v38 = xf_mul(v3, v37);
    const Xf v8 = r.ext(3, 1);
    const Xf v39 = xf_sub(v38, v8);
    const Xf v40 = xf_mul_base(v39, v1);
    const uint64_t v41 = gl_add(0x1ULL, v0);
    const uint64_t v42 = gl_sub(v41, v5);
    const Xf v43 = xf_mul_base(v40, v42);
    const uint64_t v44 = gl_sub(v1, 0x5BULL);
    const uint64_t v45 = gl_sub(v1, 0x5DULL);
    const uint64_t v46 = gl_mul(v44, v45);
    const uint64_t v47 = gl_sub(v1, 0x3CULL);
    const uint64_t v48 = gl_mul(v46, v47);
    const uint64_t v49 = gl_sub(v1, 0x3EULL);
    const uint64_t v50 = gl_mul(v48, v49);
    const uint64_t v51 = gl_sub(v1, 0x2BULL);
    const uint64_t v52 = gl_mul(v50, v51);
    const uint64_t v53 = gl_sub(v1, 0x2DULL);
    const uint64_t v54 = gl_mul(v52, v53);
    const uint64_t v55 = gl_sub(v1, 0x2CULL);
    const uint64_t v56 = gl_mul(v54, v55);
    const uint64_t v57 = gl_sub(v1, 0x2EULL);
    const uint64_t v58 = gl_mul(v56, v57);
    const Xf v59 = xf_sub(v3, v8);
    const Xf v60 = xf_mul_base(v59, v58);
    const Xf v61 = xf_add(v43, v60);
    const uint64_t v62 = gl_sub(v0, v5);
    const Xf v63 = xf_mul_base(v59, v62);
    const Xf v64 = xf_add(v61, v63);
    r.store(6, xf_mul_base(v64, r.zinv(1)));
    const Xf v65 = xf_mul(u[4], v4);
    const Xf v66 = xf_add(v32, v65);
    const Xf v67 = xf_add(v34, v66);
    const Xf v68 = xf_add(v36, v67);
    const Xf v9 = r.ext(4, 1);
    const Xf v69 = xf_sub(v68, v9);
    const Xf v70 = xf_mul_base(v69, v23);
    const Xf v71 = xf_sub(v4, v9);
    const Xf v72 = xf_mul_base(v71, v24);
    const Xf v73 = xf_add(v70, v72);
    r.store(7, xf_mul_base(v73, r.zinv(1)));
    const Xf v74 = xf_sub(v3, u[5]);
    r.store(8, xf_mul_base(v74, r.zinv(2)));
    const Xf v75 = xf_sub(v4, u[6]);
    r.store(9, xf_mul_base(v75, r.zinv(2)));
    r.store(0, Xf{gl_mul(v0, r.zinv(0)), 0, 0});
  }
};

// memory: 72 recorded operations, 47 after lowering; 11 quotients;
// a position: 51 multiplies, 12 adds, 32 subs, 10 words read, 33 written
struct QuotientsMemory {
  static constexpr uint64_t kKey = 0x99E49D1581A4C357ULL;
  static constexpr int kBase = 4, kExt = 1, kOutputs = 11, kUniform = 5, kParams = 0;

  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,
                            const long long* params, Xf* u) {
    (void)ch;
    (void)tm;
    (void)params;
    const Xf v10 = Xf{ch[9], ch[10], ch[11]};
    const Xf v11 = Xf{ch[12], ch[13], ch[14]};
    const Xf v12 = Xf{ch[15], ch[16], ch[17]};
    const Xf v13 = Xf{ch[21], ch[22], ch[23]};
    const Xf v14 = Xf{tm[3], tm[4], tm[5]};
    u[0] = v10;
    u[1] = v13;
    u[2] = v11;
    u[3] = v12;
    u[4] = v14;
  }

  template <class R>
  GL_FN static void row(const R& r, const Xf* u) {
    (void)u;
    const uint64_t v6 = r.base(1, 1);
    const uint64_t v1 = r.base(1, 0);
    const uint64_t v15 = gl_sub(v6, v1);
    const uint64_t v16 = gl_sub(v15, 0x1ULL);
    const uint64_t v17 = gl_mul(v15, v16);
    r.store(3, Xf{gl_mul(v17, r.zinv(1)), 0, 0});
    const uint64_t v7 = r.base(2, 1);
    const uint64_t v18 = gl_mul(v15, v7);
    r.store(4, Xf{gl_mul(v18, r.zinv(1)), 0, 0});
    const uint64_t v8 = r.base(3, 1);
    const uint64_t v19 = gl_sub(v8, 0x1ULL);
    const uint64_t v20 = gl_mul(v19, v8);
    r.store(5, Xf{gl_mul(v20, r.zinv(1)), 0, 0});
    const uint64_t v3 = r.base(3, 0);
    const uint64_t v21 = gl_mul(v15, v3);
    r.store(6, Xf{gl_mul(v21, r.zinv(1)), 0, 0});
    const uint64_t v2 = r.base(2, 0);
    const uint64_t v22 = gl_sub(v7, v2);
    const uint64_t v23 = gl_mul(v3, v22);
    r.store(7, Xf{gl_mul(v23, r.zinv(1)), 0, 0});
    const uint64_t v24 = gl_sub(v6, 0x1ULL);
    const uint64_t v25 = gl_sub(v24, v1);
    const uint64_t v5 = r.base(0, 1);
    const uint64_t v26 = gl_sub(v5, 0x1ULL);
    const uint64_t v0 = r.base(0, 0);
    const uint64_t v27 = gl_sub(v26, v0);
    const uint64_t v28 = gl_mul(v25, v27);
    r.store(8, Xf{gl_mul(v28, r.zinv(1)), 0, 0});
    const Xf v29 = xf_mul_base(u[0], v0);
    const Xf v30 = xf_sub(u[1], v29);
    const Xf v31 = xf_mul_base(u[2], v1);
    const Xf v32 = xf_sub(v30, v31);
    const Xf v33 = xf_mul_base(u[3], v2);
    const Xf v34 = xf_sub(v32, v33);
    const Xf v4 = r.ext(4, 0);
    const Xf v35 = xf_mul(v4, v34);
    const Xf v9 = r.ext(4, 1);
    const Xf v36 = xf_sub(v35, v9);
    const uint64_t v37 = gl_sub(0x1ULL, v3);
    const Xf v38 = xf_mul_base(v36, v37);
    const Xf v39 = xf_sub(v4, v9);
    const Xf v40 = xf_mul_base(v39, v3);
    const Xf v41 = xf_add(v38, v40);
    r.store(9, xf_mul_base(v41, r.zinv(1)));
    const Xf v42 = xf_sub(v35, u[4]);
    const Xf v43 = xf_mul_base(v42, v37);
    const Xf v44 = xf_sub(v4, u[4]);
    const Xf v45 = xf_mul_base(v44, v3);
    const Xf v46 = xf_add(v43, v45);
    r.store(10, xf_mul_base(v46, r.zinv(2)));
    r.store(0, Xf{gl_mul(v0, r.zinv(0)), 0, 0});
    r.store(1, Xf{gl_mul(v1, r.zinv(0)), 0, 0});
    r.store(2, Xf{gl_mul(v2, r.zinv(0)), 0, 0});
  }
};

// input: 27 recorded operations, 13 after lowering; 3 quotients;
// a position: 18 multiplies, 7 adds, 9 subs, 7 words read, 9 written
struct QuotientsInput {
  static constexpr uint64_t kKey = 0xFF248CAAE3E2BC79ULL;
  static constexpr int kBase = 1, kExt = 1, kOutputs = 3, kUniform = 2, kParams = 1;

  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,
                            const long long* params, Xf* u) {
    (void)ch;
    (void)tm;
    (void)params;
    const Xf v4 = Xf{ch[24], ch[25], ch[26]};
    const Xf v5 = Xf{tm[6], tm[7], tm[8]};
    const Xf v10 = xf_pow(v4, params[0]);
    const Xf v11 = xf_mul(v5, v10);
    u[0] = v4;
    u[1] = v11;
  }

  template <class R>
  GL_FN static void row(const R& r, const Xf* u) {
    (void)u;
    const Xf v1 = r.ext(1, 0);
    const uint64_t v0 = r.base(0, 0);
    const Xf v6 = xf_sub_base(v1, v0);
    r.store(0, xf_mul_base(v6, r.zinv(0)));
    const Xf v7 = xf_mul(v1, u[0]);
    const uint64_t v2 = r.base(0, 1);
    const Xf v8 = xf_add_base(v7, v2);
    const Xf v3 = r.ext(1, 1);
    const Xf v9 = xf_sub(v8, v3);
    r.store(1, xf_mul_base(v9, r.zinv(1)));
    const Xf v12 = xf_sub(v1, u[1]);
    r.store(2, xf_mul_base(v12, r.zinv(2)));
  }
};

// output: 27 recorded operations, 13 after lowering; 3 quotients;
// a position: 18 multiplies, 7 adds, 9 subs, 7 words read, 9 written
struct QuotientsOutput {
  static constexpr uint64_t kKey = 0xF0D9E97F43AA94D2ULL;
  static constexpr int kBase = 1, kExt = 1, kOutputs = 3, kUniform = 2, kParams = 1;

  GL_FN static void uniform(const uint64_t* ch, const uint64_t* tm,
                            const long long* params, Xf* u) {
    (void)ch;
    (void)tm;
    (void)params;
    const Xf v4 = Xf{ch[27], ch[28], ch[29]};
    const Xf v5 = Xf{tm[9], tm[10], tm[11]};
    const Xf v10 = xf_pow(v4, params[0]);
    const Xf v11 = xf_mul(v5, v10);
    u[0] = v4;
    u[1] = v11;
  }

  template <class R>
  GL_FN static void row(const R& r, const Xf* u) {
    (void)u;
    const Xf v1 = r.ext(1, 0);
    const uint64_t v0 = r.base(0, 0);
    const Xf v6 = xf_sub_base(v1, v0);
    r.store(0, xf_mul_base(v6, r.zinv(0)));
    const Xf v7 = xf_mul(v1, u[0]);
    const uint64_t v2 = r.base(0, 1);
    const Xf v8 = xf_add_base(v7, v2);
    const Xf v3 = r.ext(1, 1);
    const Xf v9 = xf_sub(v8, v3);
    r.store(1, xf_mul_base(v9, r.zinv(1)));
    const Xf v12 = xf_sub(v1, u[1]);
    r.store(2, xf_mul_base(v12, r.zinv(2)));
  }
};

}  // namespace

// X(index, struct) for each table, in the prover's order
#define QUOTIENT_TABLES(X) X(0, QuotientsProcessor) X(1, QuotientsInstruction) X(2, QuotientsMemory) X(3, QuotientsInput) X(4, QuotientsOutput)
